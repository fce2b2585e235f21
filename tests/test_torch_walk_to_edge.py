"""The port's walk -> edge scatter-max against the JAX package, on the CPU.

``walk_to_edge_plain`` (what the wrapper runs on the CPU, and what the CUDA
forward is held to on the card) is held bit for bit to JAX's
``walk_to_edge_max_jnp`` and to the Pallas ``walk_to_edge_max`` run in
interpret mode (``TEMPME_PALLAS=1``): both take a max of the same float32
values. Its gradient is held to ``jax.vjp`` of ``walk_to_edge_max_jnp`` to
rtol 1e-6, atol 1e-7: both split each cotangent evenly over the slots that
attain the max, and each slot's share is summed over the targets in
another order. ``walk_to_edge_count_plain`` (the card tests' reference for
the kernel's ``cnt``) is held exactly to a count in numpy. The inputs, made
with numpy from a seed, hold exact ties among matching slots, matching
slots that tie with the 0 fill or lie below it, targets that match
nothing, and id 0 on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.ops import segment as jseg
from tempme_tpu_torch.ops.kernels.walk_to_edge import (
    walk_to_edge, walk_to_edge_count_plain, walk_to_edge_plain)

B, S, T = 6, 13, 9


def _inputs(seed):
    r = np.random.RandomState(seed)
    ids = r.randint(0, 6, (B, S)).astype(np.int32)
    tgt = r.randint(0, 8, (B, T)).astype(np.int32)
    imp = np.round(r.rand(B, S) * 4) / 4          # exact ties: 0.25 steps
    imp = imp.astype(np.float32)
    imp[1] = -imp[1]                  # matching slots below the fill
    imp[2] = 0.0                      # matching slots tie with the fill
    tgt[3] = 99                       # no target matches a slot
    ids[4, ::2] = 0                   # padding id 0 on both sides
    tgt[4, ::3] = 0
    ct = r.randn(B, T).astype(np.float32)
    return ids, imp, tgt, ct


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_forward_matches_jnp_and_pallas(seed, monkeypatch):
    ids, imp, tgt, _ = _inputs(seed)
    got = walk_to_edge(*(torch.from_numpy(x) for x in (ids, imp, tgt)))
    want = np.asarray(jseg.walk_to_edge_max_jnp(ids, imp, tgt))
    monkeypatch.setenv("TEMPME_PALLAS", "1")
    pallas = np.asarray(jseg.walk_to_edge_max(ids, imp, tgt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert (got[1] <= 0).all() and not got[3].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_gradient_matches_jax_vjp(seed):
    ids, imp, tgt, ct = _inputs(seed)
    leaf = torch.from_numpy(imp).requires_grad_()
    out = walk_to_edge_plain(torch.from_numpy(ids), leaf,
                             torch.from_numpy(tgt))
    (got,) = torch.autograd.grad(out, [leaf], torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda w: jseg.walk_to_edge_max_jnp(ids, w, tgt),
                     jnp.asarray(imp))
    (want,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert (got[2] != 0).any()        # the fill's ties take a share


def test_count_plain_matches_numpy():
    ids, imp, tgt, _ = _inputs(2)
    got = walk_to_edge_count_plain(*(torch.from_numpy(x)
                                     for x in (ids, imp, tgt)))
    scores = np.where(tgt[:, :, None] == ids[:, None, :], imp[:, None, :],
                      np.float32(0))
    want = (scores == scores.max(-1, keepdims=True)).sum(-1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[3] == S).all()        # nothing matches: every fill ties
