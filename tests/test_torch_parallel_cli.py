"""The port's train CLI over gloo on the CPU: two processes with
`--distributed localhost:PORT,RANK,2 --mesh data=2` (UNet_base at 16x16,
base width 8, global batch 8, one epoch: one step and one validation
batch), as tests/test_multihost_smoke.py runs JAX's; beside them one
process without a mesh on the same data and seed.

Both ranks exit 0 and log their place on the mesh; rank 0 alone writes a
checkpoint (each rank is given its own --ckpt-dir), and the epoch's metrics
are those of the global batch (rank 0 logs the one-process run's). The
checkpoint holds what the one-process run's holds: the running statistics
and Adam's first moments to FP32_TOL of each tensor's largest value (fp32
sums taken in another order; a tensor of moments at rounding level, 1e-11
beside 1e-3, to FP32_TOL of a thousandth of the largest), and the parameters
where the one-process
update was decided by its gradient's sign (|update| >= 0.99 lr: Adam's first
step is lr * g / (|g| + eps), so an element whose gradient is at rounding
level, such as a conv bias before a BN, may step by any fraction of lr
either way). It loads into the one-process eval CLI, a one-process train
run resumes from it, and so does the two-rank run with `--resume auto`
(rank 1's own --ckpt-dir is empty: every rank takes rank 0's newest).
`--distributed` without `--mesh` is refused.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
FP32_TOL = 1e-4
LR = 1e-3  # the preset's learning rate, the first step's size
COMMON = ["--model", "UNet_base", "--device", "cpu", "--epochs", "1",
          "--set", "data.img_size=16", "data.batch_size=8", "model.base_width=8"]


def _write_split(root: Path, n: int, seed: int) -> None:
    os.makedirs(root / "images")
    os.makedirs(root / "masks")
    rs = np.random.RandomState(seed)
    for i in range(n):
        np.save(root / "images" / f"s{i}.npy", rs.rand(4, 16, 16).astype(np.float32) * 0.1)
        np.save(root / "masks" / f"s{i}.npy", (rs.rand(16, 16) > 0.5).astype(np.uint8))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, env):
    return subprocess.Popen([sys.executable, "-m", *args], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    """Each process's exit code and output, each waited for with its own
    timeout; whatever is left is killed."""
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=TIMEOUT)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


def _rel(got, want, floor=1e-30):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def test_two_rank_train_cli_matches_one_process(tmp_path):
    _write_split(tmp_path / "train", 8, 0)
    _write_split(tmp_path / "val", 4, 1)
    data = ["--train-dir", str(tmp_path / "train"), "--val-dir", str(tmp_path / "val")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = _free_port()
    train = ["accunet_tpu_torch.cli.train", *COMMON, *data]
    procs = [_start([*train, "--distributed", f"localhost:{port},{r},2", "--mesh", "data=2",
                     "--ckpt-dir", str(tmp_path / f"ck{r}")], env) for r in range(2)]
    procs.append(_start([*train, "--ckpt-dir", str(tmp_path / "single")], env))
    outs = _finish(procs)
    for name, (out, rc) in zip(("rank 0", "rank 1", "one process"), outs):
        assert rc == 0, f"{name}:\n{out[-3000:]}"
    assert "rank 0 of 2 at {'data': 0" in outs[0][0]
    assert "rank 1 of 2 at {'data': 1" in outs[1][0]
    # rank 0 logs the epoch, and its metrics are the global batch's
    epoch_line = [ln for ln in outs[0][0].splitlines() if ln.startswith("epoch 1 ")]
    single_line = [ln for ln in outs[2][0].splitlines() if ln.startswith("epoch 1 ")]
    assert len(epoch_line) == 1 and "epoch 1 " not in outs[1][0]
    assert epoch_line[0].split("|")[1] == single_line[0].split("|")[1]  # val loss and dice

    ckpt = tmp_path / "ck0" / "epoch_0001.pth.tar"
    assert ckpt.exists() and not (tmp_path / "ck1").exists()
    got = torch.load(ckpt, weights_only=True)
    want = torch.load(tmp_path / "single" / "epoch_0001.pth.tar", weights_only=True)
    assert got["state_dict"].keys() == want["state_dict"].keys()
    from accunet_tpu_torch.config import get_config
    from accunet_tpu_torch.data.dataset import SegmentationDataset
    from accunet_tpu_torch.models import build, init_parameters

    # the model and initialisation the CLIs build
    n_ch = SegmentationDataset(str(tmp_path / "train"), 16)[0][0]["image"].shape[-1]
    model = build("UNet_base", n_channels=n_ch, n_classes=1, base_width=8)
    seed = get_config("UNet_base").train.seed
    init = init_parameters(model, torch.Generator().manual_seed(seed)).state_dict()
    params = {n for n, _ in model.named_parameters()}
    n_decided = 0
    for name, w in want["state_dict"].items():
        g = got["state_dict"][name]
        if name in params:
            decided = (w - init[name]).abs() >= 0.99 * LR
            n_decided += int(decided.sum())
            assert torch.allclose(g[decided], w[decided], rtol=0, atol=1e-6), name
        elif w.is_floating_point():  # running statistics
            assert _rel(g, w) <= FP32_TOL, name
        else:
            assert torch.equal(g, w), name
    assert n_decided > 0.5 * sum(int(want["state_dict"][n].numel()) for n in params)
    moments = want["optimizer"]["state"]
    largest = max(float(st["exp_avg"].abs().max()) for st in moments.values())
    for i, st in moments.items():
        m = got["optimizer"]["state"][i]["exp_avg"]
        assert _rel(m, st["exp_avg"], 1e-3 * largest) <= FP32_TOL, i

    # the one-process CLIs take the mesh run's checkpoint
    evaluate = ["accunet_tpu_torch.cli.eval", "--model", "UNet_base", "--device", "cpu",
                "--test-dir", str(tmp_path / "val"), "--img-size", "16", "--batch", "2",
                "--model-kwargs", "{'base_width': 8}", "--torch-ckpt", str(ckpt),
                "--csv", str(tmp_path / "m.csv"), "--result", str(tmp_path / "r.txt")]
    resume = [*train, "--epochs", "2", "--resume", str(ckpt), "--ckpt-dir",
              str(tmp_path / "resumed")]
    # and the mesh resumes from rank 0's newest checkpoint on every rank
    # (rank 1's own --ckpt-dir holds none)
    port = _free_port()
    mesh_resume = [_start([*train, "--epochs", "2", "--resume", "auto", "--distributed",
                           f"localhost:{port},{r},2", "--mesh", "data=2", "--ckpt-dir",
                           str(tmp_path / f"ck{r}")], env) for r in range(2)]
    outs = _finish([_start(evaluate, env), _start(resume, env), *mesh_resume])
    for name, (out, rc) in zip(("eval", "resume", "mesh rank 0", "mesh rank 1"), outs):
        assert rc == 0, f"{name}:\n{out[-3000:]}"
    assert (tmp_path / "resumed" / "epoch_0002.pth.tar").exists()
    assert f"resumed from {ckpt} at epoch 1" in outs[2][0]
    assert (tmp_path / "ck0" / "epoch_0002.pth.tar").exists() and not (tmp_path / "ck1").exists()


def test_distributed_without_mesh_is_refused():
    out = subprocess.run([sys.executable, "-m", "accunet_tpu_torch.cli.train", "--device", "cpu",
                          "--synthetic", "--distributed", "localhost:1,0,2"],
                         cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 2 and "--mesh data=N" in out.stderr
