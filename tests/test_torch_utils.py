"""The port's logging and profiling helpers (`radvlm_tpu_torch/utils/`):
`StepTimer` equals the JAX package's under the same clock readings,
`setup_logging` names its file as the JAX one does (`_p{rank}` only under a
process group), `process_zero_log` logs on rank 0, and `trace` writes a
Chrome trace of the CPU with the `annotate` spans in it.
"""

import json
import logging
import socket
import time

import torch

from radvlm_tpu.utils import profiling as jprof
from radvlm_tpu_torch.utils import logging_utils, profiling


def test_step_timer_equals_jax(monkeypatch):
    clock = [10.0, 10.0, 11.5, 12.0, 14.25, 14.5, 14.5, 15.0, 17.0, 17.5, 21.0, 22.0]

    def run(mod):
        it = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(it))
        timer = mod.StepTimer(ema=0.8)
        out = [timer.tick(tokens=n) for n in (0, 128, 64, 256)]
        timer.reset_window()
        out.append(timer.tick(tokens=32))
        out.append(timer.tick())
        return out, timer.total_steps, timer.total_tokens, timer.step_time

    ours = run(profiling)
    assert ours == run(jprof)
    assert ours[1:3] == (6, 480) and ours[0][1]["tokens_per_sec"] == 128 / 1.5


def _fresh_logger_name(tag):
    return f"radvlm_test_{tag}_{time.time_ns()}"


def test_setup_logging_file_name(tmp_path):
    name = _fresh_logger_name("plain")
    logger = logging_utils.setup_logging(name, log_dir=str(tmp_path))
    try:
        assert [type(h).__name__ for h in logger.handlers] == ["StreamHandler",
                                                               "RotatingFileHandler"]
        assert logger.handlers[1].baseFilename == str(tmp_path / f"{name}.log")
        assert logging_utils.setup_logging(name, log_dir=str(tmp_path)) is logger
        assert len(logger.handlers) == 2  # a second call adds no handler
        logger.info("hello %d", 7)
        logger.handlers[1].flush()
        assert "| INFO | " in (tmp_path / f"{name}.log").read_text()
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers.clear()


def test_setup_logging_under_a_process_group(tmp_path):
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    name = _fresh_logger_name("group")
    try:
        logger = logging_utils.setup_logging(name, log_dir=str(tmp_path))
        assert logger.handlers[1].baseFilename == str(tmp_path / f"{name}_p0.log")
        for h in logger.handlers:
            h.close()
        logger.handlers.clear()
    finally:
        dist.destroy_process_group()


def test_process_zero_log_without_a_group(caplog):
    logger = logging.getLogger(_fresh_logger_name("zero"))
    with caplog.at_level(logging.INFO, logger=logger.name):
        logging_utils.process_zero_log(logger, "step %d", 3)
    assert [r.getMessage() for r in caplog.records] == ["step 3"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("radvlm_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "radvlm_span" for e in events)
