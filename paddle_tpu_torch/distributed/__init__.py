"""Distributed tier of the port (paddle_tpu/distributed). The two
environment readers that ``io.DistributedBatchSampler`` needs are here
(``env.py``), and the fault-injection seam of the PS transport
(``ps/rpc.py``); the rest waits for ROADMAP Queue 1 items 7 and 8."""
