"""paddle.utils (paddle_tpu/utils): ``LogWriter`` / ``read_scalars``
(``log_writer.py``). ``unique_name``, ``dlpack``, ``cpp_extension``,
``download`` and ``run_check`` are ROADMAP Queue 1 item 9."""
from .log_writer import LogWriter, read_scalars  # noqa: F401

__all__ = ["LogWriter", "read_scalars"]
