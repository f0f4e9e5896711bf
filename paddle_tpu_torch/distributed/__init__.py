"""Distributed tier of the port (paddle_tpu/distributed). The two
environment readers that ``io.DistributedBatchSampler`` needs are here
(``env.py``), and the parameter-server tier (``ps/``: the transport,
tables, replication, client, embedding prefetch, the device cache and
snapshot publish); the collective tier waits for ROADMAP Queue 1 item 7."""
