"""The fault-injection seam of the PS transport
(paddle_tpu/distributed/ps/rpc.py ``_fault_injector``,
``set_fault_injector``, ``_fault``).

The transport itself (framing, retries, the replay cache) is ROADMAP
Queue 1 item 8. The seam is here already because the serve loop consults
it at its scheduler beat, ``("serve", "beat", "tick")``
(inference/serving.py), and ``testing/faults.py`` installs injectors
through it.
"""
from __future__ import annotations

__all__ = ["set_fault_injector"]

# A test-only hook consulted at boundaries. None in production; the branch
# is one global load per event.
_fault_injector = None


def set_fault_injector(injector):
    """Install (or clear, with None) the process-global fault injector.
    Use paddle_tpu_torch.testing.faults.inject(...) rather than calling
    this directly."""
    global _fault_injector
    _fault_injector = injector


def _fault(side, event, method, endpoint=None):
    inj = _fault_injector
    if inj is None:
        return None
    return inj.on_event(side, event, method, endpoint)
