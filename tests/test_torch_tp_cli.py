"""The serving CLIs at tp 2 on the CPU: this process runs rank 0 (the
prints, the frontend, the HTTP server), one spawned gloo rank follows
(``launch/mesh.py``'s ``run_ranks``).

* ``serve --tp 2 --reduced`` prints the tp 1 run's ``sample:`` line and
  its pool a shard: half the pool.
* ``serve_http --tp 2 --dp 1 --smoke`` passes its built-in client (SSE
  streams, a disconnect that frees its pages, clean pools).
* ``serve_async --tp 2 --smoke --cancel-every 3`` finishes its open loop
  with a cancelled client.
"""
import pytest

from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_async as tserve_async
from repro_torch.launch import serve_http as tserve_http
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu"]


def _line(out: str, head: str) -> str:
    return next(line for line in out.splitlines() if line.startswith(head))


def test_serve_tp2_prints_the_single_shard_sample(capsys):
    flags = ARGS + ["--batch", "2", "--steps", "4", "--spec-k", "2"]
    tserve.main(flags)
    one = capsys.readouterr().out
    tserve.main(flags + ["--tp", "2"])
    two = capsys.readouterr().out
    assert _line(two, "sample:") == _line(one, "sample:")
    assert _line(two, "speculation:") == _line(one, "speculation:")
    pool = int(_line(one, "kv codec").split("pool ")[1].split(" B")[0])
    tp = _line(two, "tensor parallel:")
    assert f"tp 2 on gloo ranks, {pool // 2} B of pool a shard" in tp


def test_serve_http_tp2_smoke_passes(capsys):
    with pytest.raises(SystemExit) as ei:
        tserve_http.main(ARGS + ["--smoke", "--tp", "2", "--dp", "1"])
    out = capsys.readouterr().out
    assert ei.value.code == 0, out
    assert "smoke: OK" in out and "tp 2 dp 1" in out


def test_serve_async_tp2_smoke_runs(capsys):
    records = tserve_async.main(ARGS + ["--smoke", "--tp", "2",
                                        "--cancel-every", "3"])
    out = capsys.readouterr().out
    assert len(records) == 6 and "open loop: 6 requests" in out
    assert sum(r["reason"] == "cancelled" for r in records) >= 1
    assert "sample:" in out
