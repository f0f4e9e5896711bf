"""The parameter-server tier (paddle_tpu/distributed/ps). Only rpc's
fault-injection seam is ported (``rpc.set_fault_injector`` / ``_fault``);
the rest of the tier is ROADMAP Queue 1 item 8."""
