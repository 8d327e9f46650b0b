"""Rank processes of tests/test_torch_parallel.py: one session of the port's
parallel/ package over gloo on the CPU.

    python -m tests.torch_parallel_workers SESSION RANK WORLD PORT DIR

reads its inputs from DIR (written by the test with torch.save) and writes
DIR/out_<session>_<rank>.pt. It imports torch and the port only, never JAX.
"""

from __future__ import annotations

import sys
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from accunet_tpu_torch.parallel import seq_scan
from accunet_tpu_torch.parallel.mesh import MeshSpec, make_mesh

ACC_KW = dict(n_channels=3, n_classes=1, n_filts=8)


def scan_case(mesh, inputs):
    """sequence_parallel_scan on this rank's shards (float32): h and the
    gradients in a and b for the shard of the cotangent; and
    shard_mapped_scan on the whole float64 sequence, h and its gradients."""
    group, n, i = mesh.group("seq"), mesh.shape["seq"], mesh.coords["seq"]
    a, b, g = (inputs[k] for k in ("a", "b", "g"))
    per = a.shape[1] // n
    a_s, b_s = (t[:, i * per:(i + 1) * per].clone().requires_grad_() for t in (a, b))
    h = seq_scan.sequence_parallel_scan(a_s, b_s, group)
    h.backward(g[:, i * per:(i + 1) * per])
    a64, b64 = (t.double().requires_grad_() for t in (a, b))
    h64 = seq_scan.shard_mapped_scan(a64, b64, mesh)
    h64.backward(g.double())
    return {"h": h.detach(), "da": a_s.grad, "db": b_s.grad, "h64": h64.detach(),
            "da64": a64.grad, "db64": b64.grad}


def ssm_case(mesh, inputs):
    """SS2D and StructureAwareSSM forwards under sequence_sharding, with the
    number of scans that took the route."""
    from accunet_tpu_torch.nn.ss2d import SS2D
    from accunet_tpu_torch.nn.ssm import StructureAwareSSM

    calls = []
    routed = seq_scan.shard_mapped_scan

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return routed(*args, **kw)

    seq_scan.shard_mapped_scan = counting
    out = {}
    try:
        for key, mod in (("ss2d", SS2D(12, 4)), ("ssm", StructureAwareSSM(16, 4))):
            mod.load_state_dict(inputs[f"{key}_sd"], strict=True)
            calls.clear()
            with torch.no_grad(), seq_scan.sequence_sharding(mesh):
                out[key] = mod(inputs[f"{key}_x"])
            out[f"{key}_routed"] = len(calls)
    finally:
        seq_scan.shard_mapped_scan = routed
    return out


def acc_step(mesh, inputs, min_weight_size=2 ** 18):
    """One train step of ACC_UNet (float64) on this rank's data slice of the
    global batch: the loss, the gradients before the update (the sharded
    ones as this rank's shards), the whole parameters, Adam moments and
    running statistics after it, and the sharded parameters' local shapes."""
    from accunet_tpu_torch.models import build
    from accunet_tpu_torch.parallel.mesh import batch_slice
    from accunet_tpu_torch.train.engine import make_train_fns, whole_state

    model = build("ACC_UNet", **ACC_KW).double()
    # rank 0's weights reach every rank by the engine's broadcast
    if mesh.rank == 0:
        model.load_state_dict(inputs["acc_sd"], strict=True)
    fns = make_train_fns(model, mesh=mesh, min_weight_size=min_weight_size)
    state = fns.state
    grads = {}
    names = {id(p): n for n, p in model.named_parameters()}
    if state.sharding is not None:
        names.update({id(it.shard): it.name for it in state.sharding.items})
    step = state.optimizer.step

    def recording_step(*args, **kw):
        for p in state.optimizer_params():
            if p.grad is not None:
                grads[names[id(p)]] = p.grad.clone()
        return step(*args, **kw)

    state.optimizer.step = recording_step
    rows = batch_slice(mesh, inputs["image"].shape[0])
    batch = {"image": inputs["image"][rows], "mask": inputs["mask"][rows]}
    _, stats = fns.train_step(state, batch)
    model_sd, opt_sd = whole_state(state)
    shards = {} if state.sharding is None else {
        it.name: (it.dim, tuple(it.shard.shape), tuple(model_sd[it.name].shape))
        for it in state.sharding.items}
    return {"loss": stats["loss"], "dice": stats["dice"], "grads": grads, "model_sd": model_sd,
            "opt_state": opt_sd["state"], "shards": shards, "model_index": mesh.coords["model"]}


def run(session: str, rank: int, world: int, port: int, root: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(root / "inputs.pt", weights_only=False)
        seq = make_mesh(MeshSpec(data=1, model=1, seq=world))
        out = {"scan": scan_case(seq, inputs)}
        if session == "world2":
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # the seq route must not fall back here
                out["ssm"] = ssm_case(seq, inputs)
            out["data2"] = acc_step(make_mesh(MeshSpec(data=2)), inputs)
        else:
            out["data2_model2"] = acc_step(make_mesh(MeshSpec(data=2, model=2)), inputs,
                                           min_weight_size=2 ** 10)
        torch.save(out, root / f"out_{session}_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), Path(sys.argv[5]))
