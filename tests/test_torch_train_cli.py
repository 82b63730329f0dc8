"""``python -m repro_torch.launch.train`` with the depth, microbatch and
checkpoint flags, on the CPU at the reduced width: the printed config
line shows the cut depth, the config's optimizer (Adafactor for
command-r-plus-104b, AdamW for mamba2-2.7b) and the microbatch count;
the steps' losses are finite; ``--ckpt-every 0`` writes no checkpoint
directory."""
import numpy as np
import pytest

from repro_torch.launch import train as ttrain
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("arch, optimizer", [
    ("command-r-plus-104b", "adafactor"), ("mamba2-2.7b", "adamw")])
def test_train_cli_cuts_depth_and_microbatches(tmp_path, capsys, arch,
                                               optimizer):
    ckpt = tmp_path / "ckpt"
    res = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--layers", "2", "--microbatches", "2",
                       "--ckpt-every", "0", "--ckpt", str(ckpt),
                       "--steps", "2", "--seq", "32", "--global-batch", "4"])
    head = capsys.readouterr().out.splitlines()[0]
    assert head.startswith(arch), head
    assert "2 layers, attn_impl" in head, head
    assert f"optimizer {optimizer}, 2 microbatches, device cpu" in head, head
    assert res["final_step"] == 2 and res["restarts"] == 0
    assert np.isfinite([m["loss"] for m in res["metrics"]]).all()
    assert not ckpt.exists()
