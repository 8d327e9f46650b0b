"""The port's UNext_CMRF family vs the JAX package on the CPU, at full width,
32x32, batch 2: the four distinct topologies among the seven ported names
(UNext_CMRF, whose forward _PP and _hd share; _enc_dec; _enc_MLFC, whose
decoder-CMRF form is _enc_dec_MLFC; _dense_skip) in eval mode, and
_enc_dec, which holds both the CMRF encoder and the CMRF decoder, in a
train-mode forward with every running statistic (the CMRF BNs at eps 1e-3,
flax momentum 0.97; the others at 1e-5, 0.9).

Weights as in tests/test_torch_unext.py (a numpy tree shaped by
jax.eval_shape, a strict load); tolerance 1e-5 in fp32.
"""

import numpy as np
import pytest

import torch

from accunet_tpu.models.unext_cmrf import build_unext_cmrf as j_build
from accunet_tpu_torch.models import build
from tests.test_torch_unext import TOL, _port, _stats_match, _variables, _x, jax_forward, jax_run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["UNext_CMRF", "UNext_CMRF_enc_MLFC", "UNext_CMRF_dense_skip"])
def test_cmrf_topology_eval_matches_jax(name):
    x = _x((2, 32, 32, 3))
    jmod = j_build(name)
    v = _variables(jmod, x)
    want = jax_run(lambda vv, xx: jmod.apply(vv, xx), v, x)
    port = _port(build(name, n_channels=3, n_classes=1), v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_cmrf_enc_dec_matches_jax():
    """UNext_CMRF_enc_dec (CMRF encoder and decoder3-5, no dbn3 / dbn4): the
    eval forward, then a train-mode forward and the running statistics of
    its 56 BNs (9 in each of the 6 CMRFs, dbn1, dbn2)."""
    x = _x((2, 32, 32, 3))
    jmod = j_build("UNext_CMRF_enc_dec")
    v = _variables(jmod, x)
    port = _port(build("UNext_CMRF_enc_dec", n_channels=3, n_classes=1), v)
    assert not hasattr(port, "dbn3") and not hasattr(port, "ebn1")
    want, (want_t, upd) = jax_forward(jmod, v, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
        got_t = port.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_t, want_t, **TOL)
    assert _stats_match(port, upd) == 2 * 56
