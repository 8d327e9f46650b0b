"""The selective scan (Mamba's SSM recurrence) fused into one hand-written
CUDA kernel forward and one backward (`csrc/selective_scan.cu`).

Per (b, d, n, t), with h[-1] = 0, in fp32:

    delta' = softplus(delta + bias) if delta_softplus else delta + bias
    a[t] = exp(delta'[t] * A[d, n])      x[t] = delta'[t] * u[t] * B[n, t]
    h[t] = a[t] * h[t-1] + x[t]
    y[t] = sum_n C[n, t] * h[t] + D[d] * u[t]       out[t] = y[t] * silu(z[t])

Counterparts: the forward is `selective_scan` of
accunet_tpu/ops/selective_scan.py:61-97 with its scan, the TPU kernel
`_chunked_scan_fwd` / `chunked_linear_scan` (accunet_tpu/ops/pallas/scan.py:62
/ :102, pallas_call :73), folded in; the backward is the VJP of that
function, whose scan part is the custom VJP of `chunked_linear_scan`
(scan.py:119-126): the reverse recurrence G[t] = gy[t]*C[n, t] +
a[t+1]*G[t+1] (G[L] = 0, or the last state's cotangent entering at t = L-1).

What bounds them on the H100: the function needs only its inputs and its
outputs, so neither kernel writes or reads a (B, L, D, N) tensor: the
discretisation, the scan and the C contraction happen in registers, and h
is recomputed in the backward from the state the forward saved at the start
of each chunk of `32 * chunk_steps(L)` steps, (B, D, n_chunks, N). The
kernels take contiguous fp32 (B, D, L) / (B, N, L) operands: the wrapper
makes one contiguous fp32 copy of each operand that is not (BiMamba's delta,
z, B and C are transposed views), each a small fraction of the unfused
glue's traffic.

`selective_scan_fwd_plain` and `selective_scan_bwd_plain` are the plain
versions, in the inputs' dtype (the tests run them in float64); on CPU
tensors the wrappers take them, on CUDA tensors they launch the kernels or
raise. `SelectiveScanFn` joins the two for autograd.

The return-hidden form (`selective_scan_rh_fwd` / `selective_scan_rh_bwd`,
joined by `SelectiveScanRhFn`) is the counterpart of `selective_scan_rh`
(accunet_tpu/ops/selective_scan.py:100-117) with the same TPU kernel and
its VJP folded in: no C, D or z, and every hidden state written, as a
(B, L, D, N) tensor, which is the NHWC map of D*N channels (channel d*N + n)
that Spatial-Mamba's StructureAwareSSM fuses next. Its backward takes the
cotangent of h in that layout, or in the (B, D, N, L) order of JAX's h, the
order a conv's input gradient reaches it in, and recomputes h from the
forward's chunk states (chunks of `32 * rh_chunk_steps(L)` steps) rather
than reading the (B, L, D, N) h back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accunet_tpu_torch.ops.kernels import _build
from accunet_tpu_torch.ops.kernels.scan import linear_scan_plain

LANES = 32  # a warp's lanes split a chunk into runs of chunk_steps(L) steps
BWD_WARPS = 8  # d per CTA of the backward kernel: its dB, dC partials are per 8 d
MAX_STATES = 32  # the kernels' largest N (shared memory holds two chunks of N rows of B, C)
RH_WARPS = 8  # d per CTA of the return-hidden kernels: the backward's dB partials are per 8 d


def chunk_steps(length: int, n: int = 16) -> int:
    """Steps each lane scans in registers: 2, 4 or 8, the fewest that cover
    L in one chunk, else 8, or 16 for L > 4096 with N <= 16 (a chunk is 32
    lanes x this many steps; a short L leaves few lanes idle, a long one
    takes fewer shuffles and barriers a step)."""
    if length <= 64:
        return 2
    if length <= 128:
        return 4
    return 16 if length > 4096 and n <= 16 else 8


def n_chunks(length: int, n: int = 16) -> int:
    return -(-length // (LANES * chunk_steps(length, n)))


def rh_chunk_steps(length: int) -> int:
    """Steps each lane of the return-hidden kernels scans in registers: 2
    for L <= 64, else 4 (their shared memory stages a chunk of h, 32 x this
    many steps of 8N floats)."""
    return 2 if length <= 64 else 4


def rh_n_chunks(length: int) -> int:
    return -(-length // (LANES * rh_chunk_steps(length)))


def _delta(delta, delta_bias, delta_softplus):
    pre = delta if delta_bias is None else delta + delta_bias[:, None]
    return pre, F.softplus(pre) if delta_softplus else pre


def _discretise(u, dl, A, B):
    """a = exp(delta*A), x = delta*u*B as (B, L, D, N), and h = their scan."""
    bsz, d, l = u.shape
    n = A.shape[1]
    a = torch.exp(dl.transpose(1, 2)[..., None] * A)
    x = (dl * u).transpose(1, 2)[..., None] * B.transpose(1, 2)[:, :, None, :]
    h = linear_scan_plain(a.reshape(bsz, l, d * n), x.reshape(bsz, l, d * n))
    return a, h.reshape(bsz, l, d, n)


def selective_scan_fwd_plain(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                             delta_softplus=False):
    """Plain version of the forward, in the inputs' dtype: the unfused glue
    around linear_scan_plain. u, delta, z (B, D, L); A (D, N); B, C (B, N,
    L); D, delta_bias (D,) -> (out (B, D, L), last state h[L-1] (B, D, N))."""
    _, dl = _delta(delta, delta_bias, delta_softplus)
    _, h = _discretise(u, dl, A, B)
    y = torch.einsum("bldn,bnl->bdl", h, C)
    if D is not None:
        y = y + u * D[:, None]
    if z is not None:
        y = y * F.silu(z)
    return y, h[:, -1]


def selective_scan_bwd_plain(u, delta, A, B, C, D, z, delta_bias, delta_softplus, g,
                             g_last=None):
    """Plain version of the backward, in the inputs' dtype: the cotangent g
    of out (and g_last of the last state, or None) -> (du, ddelta, dA, dB,
    dC, dD, dz, dbias), None for an absent D, z or delta_bias:

        gy = g*silu(z)      dz = g*y*silu'(z)       dD = sum_{b,t} gy*u
        G[t] = gy[t]*C[n,t] + a[t+1]*G[t+1]          (G[L] = 0; + g_last at L-1)
        dC = sum_d gy*h     dB = sum_d G*delta*u
        ddelta' = sum_n G*(h[t-1]*a*A + u*B)         dA = sum_{b,t} G*h[t-1]*a*delta
        du = sum_n G*delta*B + gy*D                   ddelta = ddelta'*sigmoid(pre)
        dbias = sum_{b,t} ddelta                      (with softplus)"""
    pre, dl = _delta(delta, delta_bias, delta_softplus)
    a, h = _discretise(u, dl, A, B)
    bsz, l, d, n = h.shape
    gy, dz = g, None
    if z is not None:
        y = torch.einsum("bldn,bnl->bdl", h, C)
        if D is not None:
            y = y + u * D[:, None]
        s = torch.sigmoid(z)
        gy = g * z * s
        dz = g * y * s * (1 + z * (1 - s))
    beta = gy.transpose(1, 2)[..., None] * C.transpose(1, 2)[:, :, None, :]
    if g_last is not None:
        beta = torch.cat([beta[:, :-1], beta[:, -1:] + g_last[:, None]], dim=1)
    G = linear_scan_plain(a.reshape(bsz, l, d * n), beta.reshape(bsz, l, d * n),
                          reverse=True).reshape(bsz, l, d, n)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    gha = G * h_prev * a
    gb = torch.einsum("bldn,bnl->bdl", G, B)
    ddl = torch.einsum("bldn,dn->bdl", gha, A) + gb * u
    dA = torch.einsum("bldn,bdl->dn", gha, dl)
    dB = torch.einsum("bldn,bdl->bnl", G, dl * u)
    dC = torch.einsum("bldn,bdl->bnl", h, gy)
    du = gb * dl
    dD = None
    if D is not None:
        du = du + gy * D[:, None]
        dD = (gy * u).sum(dim=(0, 2))
    ddelta = ddl * torch.sigmoid(pre) if delta_softplus else ddl
    dbias = ddelta.sum(dim=(0, 2)) if delta_bias is not None else None
    return du, ddelta, dA, dB, dC, dD, dz, dbias


def _check(u, delta, A, B, C, D, z, delta_bias):
    """Validate the kernels' operands: contiguous float32 on u's device."""
    if u.dim() != 3 or A.dim() != 2 or B.dim() != 3:
        raise ValueError(f"selective scan takes u (B, D, L), A (D, N), B (B, N, L); got "
                         f"{tuple(u.shape)}, {tuple(A.shape)}, {tuple(B.shape)}")
    bsz, d, l = u.shape
    n = A.shape[1]
    _build.require(u, "u", dtype=torch.float32)
    for name, t, shape in (("delta", delta, u.shape), ("A", A, (d, n)), ("B", B, (bsz, n, l)),
                           ("C", C, (bsz, n, l)), ("D", D, (d,)), ("z", z, u.shape),
                           ("delta_bias", delta_bias, (d,))):
        if t is not None:
            _build.require(t, name, shape, torch.float32, u.device)
    if n > MAX_STATES:
        raise ValueError(f"the kernels take N <= {MAX_STATES} states, got {n}")
    if bsz * d * max(l, n_chunks(l, n) * n) >= 2 ** 31:
        raise ValueError(f"selective scan shape {(bsz, d, l, n)} too large for the kernels")
    return bsz, d, l, n


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def selective_scan_fwd(u, delta, A, B, C, D=None, z=None, delta_bias=None,
                       delta_softplus=False, save_states=False):
    """The fused forward: (out, last state (B, D, N), chunk states (B, D,
    n_chunks, N) or None). Contiguous float32 operands (see `_check`); the
    chunk states, the state entering each chunk, are written with
    `save_states` (for the backward) and are None on the CPU."""
    if u.device.type == "cpu":
        return (*selective_scan_fwd_plain(u, delta, A, B, C, D, z, delta_bias, delta_softplus),
                None)
    bsz, d, l, n = _check(u, delta, A, B, C, D, z, delta_bias)
    out = torch.empty_like(u)
    last = torch.empty(bsz, d, n, dtype=torch.float32, device=u.device)
    states = (torch.empty(bsz, d, n_chunks(l, n), n, dtype=torch.float32, device=u.device)
              if save_states else None)
    err = _build.load_library().accunet_selective_scan_fwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(D),
        _ptr(z), _ptr(delta_bias), out.data_ptr(), last.data_ptr(), _ptr(states),
        bsz, d, l, n, int(delta_softplus), _build.stream_of(u))
    _build.check(err, "accunet_selective_scan_fwd")
    selective_scan_fwd.launches += 1
    return out, last, states


selective_scan_fwd.launches = 0


def selective_scan_bwd(u, delta, A, B, C, D, z, delta_bias, delta_softplus, states, g,
                       g_last=None):
    """The fused backward: the forward's operands, its chunk states and the
    cotangents g of out (B, D, L) and g_last of the last state (or None) ->
    (du, ddelta, dA, dB, dC, dD, dz, dbias), None for an absent D, z or
    delta_bias. One launch of the kernel and one of its reduction (dB and dC
    over the d-blocks, dA, dD and dbias over b), both in a fixed order."""
    if u.device.type == "cpu":
        return selective_scan_bwd_plain(u, delta, A, B, C, D, z, delta_bias, delta_softplus,
                                        g, g_last)
    bsz, d, l, n = _check(u, delta, A, B, C, D, z, delta_bias)
    _build.require(g, "g", u.shape, torch.float32, u.device)
    _build.require(states, "states", (bsz, d, n_chunks(l, n), n), torch.float32, u.device)
    if g_last is not None:
        _build.require(g_last, "g_last", (bsz, d, n), torch.float32, u.device)
    blocks = -(-d // BWD_WARPS)
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dz = torch.empty_like(u) if z is not None else None
    dB, dC = torch.empty(bsz, n, l, **f32), torch.empty(bsz, n, l, **f32)
    dA = torch.empty(d, n, **f32)
    dD = torch.empty(d, **f32) if D is not None else None
    dbias = torch.empty(d, **f32) if delta_bias is not None else None
    # per-d-block partials of dB, dC (the outputs themselves for one block)
    # and per-b partials of dA, dD, dbias
    part_bc = torch.empty(2, blocks, bsz, n, l, **f32) if blocks > 1 else None
    part_b = torch.empty(bsz, d, n + 2, **f32)
    err = _build.load_library().accunet_selective_scan_bwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(), _ptr(D),
        _ptr(z), _ptr(delta_bias), states.data_ptr(), g.data_ptr(), _ptr(g_last),
        du.data_ptr(), ddelta.data_ptr(), _ptr(dz),
        (part_bc[0] if blocks > 1 else dB).data_ptr(),
        (part_bc[1] if blocks > 1 else dC).data_ptr(), part_b.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), _ptr(dD), _ptr(dbias),
        bsz, d, l, n, int(delta_softplus), _build.stream_of(u))
    _build.check(err, "accunet_selective_scan_bwd")
    selective_scan_bwd.launches += 1
    return du, ddelta, dA, dB, dC, dD, dz, dbias


selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """out (and the last state) = the selective scan of float32 operands,
    differentiable in all of them through `selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, delta_softplus):
        ctx.set_materialize_grads(False)
        ops = [t if t is None else t.contiguous() for t in (u, delta, A, B, C, D, z, delta_bias)]
        out, last, states = selective_scan_fwd(*ops, delta_softplus,
                                               save_states=any(ctx.needs_input_grad))
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(*ops, states)
        return out, last

    @staticmethod
    def backward(ctx, g, g_last):
        *ops, states = ctx.saved_tensors
        g = torch.zeros_like(ops[0]) if g is None else g.contiguous()
        g_last = None if g_last is None else g_last.contiguous()
        grads = selective_scan_bwd(*ops, ctx.delta_softplus, states, g, g_last)
        return (*grads, None)


# ----------------------------------------------------------------- return-hidden


def selective_scan_rh_fwd_plain(u, delta, A, B, delta_bias=None, delta_softplus=False):
    """Plain version of the return-hidden forward, in the inputs' dtype: u,
    delta (B, D, L); A (D, N); B (B, N, L); delta_bias (D,) -> every hidden
    state h (B, L, D, N)."""
    _, dl = _delta(delta, delta_bias, delta_softplus)
    return _discretise(u, dl, A, B)[1]


def selective_scan_rh_bwd_plain(u, delta, A, B, delta_bias, delta_softplus, gh):
    """Plain version of the return-hidden backward, in the inputs' dtype: the
    cotangent gh of h (B, L, D, N) -> (du, ddelta, dA, dB, dbias), dbias None
    without delta_bias:

        G[t] = gh[t] + a[t+1]*G[t+1]                  (G[L] = 0)
        dB = sum_d G*delta*u        du = sum_n G*delta*B
        ddelta' = sum_n G*(h[t-1]*a*A + u*B)          dA = sum_{b,t} G*h[t-1]*a*delta
        ddelta = ddelta'*sigmoid(pre)                 (with softplus)
        dbias = sum_{b,t} ddelta"""
    pre, dl = _delta(delta, delta_bias, delta_softplus)
    a, h = _discretise(u, dl, A, B)
    bsz, l, d, n = h.shape
    G = linear_scan_plain(a.reshape(bsz, l, d * n), gh.reshape(bsz, l, d * n),
                          reverse=True).reshape(bsz, l, d, n)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    gha = G * h_prev * a
    gb = torch.einsum("bldn,bnl->bdl", G, B)
    ddl = torch.einsum("bldn,dn->bdl", gha, A) + gb * u
    dA = torch.einsum("bldn,bdl->dn", gha, dl)
    dB = torch.einsum("bldn,bdl->bnl", G, dl * u)
    ddelta = ddl * torch.sigmoid(pre) if delta_softplus else ddl
    dbias = ddelta.sum(dim=(0, 2)) if delta_bias is not None else None
    return gb * dl, ddelta, dA, dB, dbias


def selective_scan_rh_fwd(u, delta, A, B, delta_bias=None, delta_softplus=False,
                          save_states=False):
    """The return-hidden forward kernel: (h (B, L, D, N), chunk states (B,
    D, rh_n_chunks(L), N) or None). Contiguous float32 operands; the chunk
    states are written with `save_states` (for the backward) and are None on
    the CPU."""
    if u.device.type == "cpu":
        return selective_scan_rh_fwd_plain(u, delta, A, B, delta_bias, delta_softplus), None
    bsz, d, l, n = _check(u, delta, A, B, None, None, None, delta_bias)
    h = torch.empty(bsz, l, d, n, dtype=torch.float32, device=u.device)
    states = (torch.empty(bsz, d, rh_n_chunks(l), n, dtype=torch.float32, device=u.device)
              if save_states else None)
    err = _build.load_library().accunet_selective_scan_rh_fwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), _ptr(delta_bias),
        h.data_ptr(), _ptr(states), bsz, d, l, n, int(delta_softplus), _build.stream_of(u))
    _build.check(err, "accunet_selective_scan_rh_fwd")
    selective_scan_rh_fwd.launches += 1
    return h, states


selective_scan_rh_fwd.launches = 0


def rh_layout_read(gh: torch.Tensor) -> bool:
    """Whether the backward kernel reads the cotangent gh (B, L, D, N) as it
    lies: contiguous, or the (B, L, D, N) view of a (B, D, N, L)-contiguous
    tensor."""
    return gh.is_contiguous() or gh.permute(0, 2, 3, 1).is_contiguous()


def selective_scan_rh_bwd(u, delta, A, B, delta_bias, delta_softplus, states, gh):
    """The return-hidden backward kernel: the forward's operands, its chunk
    states and the cotangent gh of h (B, L, D, N), contiguous or a view of a
    (B, D, N, L)-contiguous tensor (`rh_layout_read`) -> (du, ddelta, dA,
    dB, dbias), dbias None without delta_bias. One launch of the kernel and
    one of the reduction it shares with selective_scan_bwd (dB over the
    d-blocks, dA and dbias over b), both in a fixed order."""
    if u.device.type == "cpu":
        return selective_scan_rh_bwd_plain(u, delta, A, B, delta_bias, delta_softplus, gh)
    bsz, d, l, n = _check(u, delta, A, B, None, None, None, delta_bias)
    dnl = not gh.is_contiguous() and gh.permute(0, 2, 3, 1).is_contiguous()
    if dnl:
        _build.require(gh.permute(0, 2, 3, 1), "gh", (bsz, d, n, l), torch.float32, u.device)
    else:
        _build.require(gh, "gh", (bsz, l, d, n), torch.float32, u.device)
    _build.require(states, "states", (bsz, d, rh_n_chunks(l), n), torch.float32, u.device)
    blocks = -(-d // RH_WARPS)
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddelta = torch.empty_like(u), torch.empty_like(u)
    dA, dB = torch.empty(d, n, **f32), torch.empty(bsz, n, l, **f32)
    dbias = torch.empty(d, **f32) if delta_bias is not None else None
    # per-d-block partials of dB (dB itself for one block), per-b ones of dA, dbias
    part_b = torch.empty(blocks, bsz, n, l, **f32) if blocks > 1 else dB
    part_bd = torch.empty(bsz, d, n + 2, **f32)
    err = _build.load_library().accunet_selective_scan_rh_bwd(
        u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(), _ptr(delta_bias),
        states.data_ptr(), gh.data_ptr(), du.data_ptr(), ddelta.data_ptr(), part_b.data_ptr(),
        part_bd.data_ptr(), dA.data_ptr(), dB.data_ptr(), _ptr(dbias),
        bsz, d, l, n, int(delta_softplus), int(dnl), _build.stream_of(u))
    _build.check(err, "accunet_selective_scan_rh_bwd")
    selective_scan_rh_bwd.launches += 1
    return du, ddelta, dA, dB, dbias


selective_scan_rh_bwd.launches = 0


class SelectiveScanRhFn(torch.autograd.Function):
    """h (B, L, D, N) = the return-hidden scan of float32 operands,
    differentiable in all of them through `selective_scan_rh_bwd`. A
    cotangent in a layout the kernel does not read (`rh_layout_read`) is
    copied once; `gh_copies` counts those copies."""

    gh_copies = 0

    @staticmethod
    def forward(ctx, u, delta, A, B, delta_bias, delta_softplus):
        ops = [t if t is None else t.contiguous() for t in (u, delta, A, B, delta_bias)]
        h, states = selective_scan_rh_fwd(*ops, delta_softplus,
                                          save_states=any(ctx.needs_input_grad))
        ctx.delta_softplus = delta_softplus
        ctx.save_for_backward(*ops, states)
        return h

    @staticmethod
    def backward(ctx, gh):
        *ops, states = ctx.saved_tensors
        if not rh_layout_read(gh):
            gh = gh.contiguous()
            SelectiveScanRhFn.gh_copies += 1
        grads = selective_scan_rh_bwd(*ops, ctx.delta_softplus, states, gh)
        return (*grads, None)
