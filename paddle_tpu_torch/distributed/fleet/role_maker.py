"""Role makers (paddle_tpu/distributed/fleet/role_maker.py; the
reference's fleet/base/role_maker.py:33-128): the PADDLE_* env contract;
the rendezvous is torch.distributed's (``bootstrap.py``)."""
from __future__ import annotations

import os

__all__ = ["Role", "PaddleCloudRoleMaker", "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        from ..env import get_rank
        return get_rank()

    def worker_num(self):
        from ..env import get_world_size
        return get_world_size()

    def server_num(self):
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        return len(eps.split(",")) if eps else 0

    def get_pserver_endpoints(self):
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        return eps.split(",") if eps else []

    def get_trainer_endpoints(self):
        from ..env import ParallelEnv
        return ParallelEnv().trainer_endpoints


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, **kwargs):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = list(server_endpoints or [])

    def worker_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def server_num(self):
        return len(self._server_endpoints) or super().server_num()

    def get_pserver_endpoints(self):
        return self._server_endpoints or super().get_pserver_endpoints()
