"""Distributed tier of the port (paddle_tpu/distributed). Only the two
environment readers that ``io.DistributedBatchSampler`` needs are here
(``env.py``); the rest waits for ROADMAP Queue 1 item 7."""
