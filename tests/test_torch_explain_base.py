"""The TGN as the explainer's frozen base, against the JAX package on the
CPU, at float32 compute.

* ``contrast(..., explain_weights=..., update_memory=False)`` and its
  gradient with respect to the explain weights, against the JAX model with
  ``fused_attend`` in Pallas interpret mode (``TEMPME_PALLAS=1``) and
  through its jnp path, at float32 compute: logits rtol 2e-4, atol 1e-5
  (as the serving tests: ``cos`` of large time arguments loses digits in
  both packages); weight gradients rtol 1e-4, atol 1e-5 of the largest.
  The memory comes back as it was.
* ``ratio_contrast`` against the JAX one, with keep masks from an
  importance with exact ties (``keep_masks_for_ratios`` equal to JAX's,
  bit for bit), and against the masked forward run once per ratio: rtol
  2e-4, atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tgn import Setup, _t
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu.train import temp_exp_main as JX
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.train import temp_exp_main as X

N = 3          # neighbours per hop
B = 6


@pytest.fixture(scope="module")
def setup():
    s = Setup(seed=3)
    jb = s.batch(120, B)
    dst_table = jnp.asarray(np.unique(s.ev.dst))
    bgd, ss, st, sb = s._jax_support(s.jg, jax.random.PRNGKey(2), jb,
                                     dst_table, 2, N, True)
    s.jb, s.jbgd, s.jsubs = jb, bgd, (ss, st, sb)
    s.tsubs = [Subgraph(*(tuple(_t(x) for x in f) for f in sub))
               for sub in (ss, st, sb)]
    # a memory with content, pending messages on some nodes, padding row 0
    # clear (as the drivers keep it)
    r = np.random.RandomState(4)
    nn_ = s.tm.num_nodes
    mem = r.randn(nn_, 12).astype(np.float32)
    buf = r.randn(nn_, s.tm.raw_message_dim).astype(np.float32)
    valid = r.rand(nn_) < 0.5
    mem[0], buf[0], valid[0] = 0.0, 0.0, False
    s.jmem = s.jmem._replace(
        memory=jnp.asarray(mem), msg_buf=jnp.asarray(buf),
        msg_valid=jnp.asarray(valid),
        last_update=jnp.asarray(r.rand(nn_).astype(np.float32) * 50),
        msg_ts=jnp.asarray(r.rand(nn_).astype(np.float32) * 50 + 50))
    s.tmem = type(s.tmem)(*(_t(x) for x in s.jmem))
    return s


def _weights(seed):
    r = np.random.RandomState(seed)
    return [r.rand(3 * B, N).astype(np.float32),
            r.rand(3 * B, N * N).astype(np.float32)]


def _jax_explained(s, params, explain, model=None):
    model = model or s.jm
    jb = s.jb
    return jax.jit(lambda p, w: JX.make_base_contrast(
        JX.LoadedBase("tgn", model, p, s.jmem, {}), s.jfeats)(
        jb.src, jb.dst, s.jbgd, jb.ts, jb.eidx, *s.jsubs, w))(params,
                                                               explain)


def _port_explained(s, model, explain):
    base = X.LoadedBase("tgn", model, s.tmem, {})
    jb = s.jb
    return X.make_base_contrast(base)(
        s.tfeats, _t(jb.src), _t(jb.dst), _t(s.jbgd), _t(jb.ts),
        _t(jb.eidx), s.tsubs, explain)


@pytest.mark.parametrize("pallas", ["1", "0"])
def test_explained_contrast_and_weight_gradient_match_jax(setup, monkeypatch,
                                                          pallas):
    monkeypatch.setenv("TEMPME_PALLAS", pallas)
    s = setup
    w = _weights(5)
    w[0][0] = 0.0                         # a weight of exactly 0
    r = np.random.RandomState(6)
    c_pos, c_neg = (r.randn(B, 1).astype(np.float32) for _ in range(2))

    def loss(p, ws):
        pos, neg = _jax_explained(s, p, ws)
        return jnp.sum(pos * c_pos) + jnp.sum(neg * c_neg), (pos, neg)
    (_, (pos_r, neg_r)), g_r = jax.value_and_grad(
        loss, argnums=1, has_aux=True)(s.params, [jnp.asarray(x) for x in w])

    tw = [torch.from_numpy(x).requires_grad_() for x in w]
    mem_before = [x.clone() for x in s.tmem]
    pos, neg = _port_explained(s, s.tm, tw)
    ((pos * _t(c_pos)).sum() + (neg * _t(c_neg)).sum()).backward()
    np.testing.assert_allclose(pos.detach().numpy(), np.asarray(pos_r),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(neg.detach().numpy(), np.asarray(neg_r),
                               rtol=2e-4, atol=1e-5)
    for a, b in zip(tw, g_r):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())
        assert np.abs(b).max() > 0
    for a, b in zip(s.tmem, mem_before):
        assert torch.equal(a, b)
    # the weights change the logits
    base_pos, _ = _port_explained(s, s.tm, None)
    assert not torch.allclose(base_pos, pos.detach())


def test_ratio_sweep_matches_jax_and_the_masked_forward(setup):
    s = setup
    ratios = (0.05, 0.2, 0.5, 1.0)
    w = _weights(7)
    w[0][:, :2] = 0.5                     # exact ties across both hops
    w[1][:, :4] = 0.5
    jkeeps = JX.keep_masks_for_ratios([jnp.asarray(x) for x in w], ratios, N)
    tkeeps = X.keep_masks_for_ratios([torch.from_numpy(x) for x in w],
                                     ratios, N)
    for js, ts in zip(jkeeps, tkeeps):
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jb = s.jb
    pos_r, neg_r = jax.jit(lambda p, k: s.jm.apply(
        p, s.jfeats, s.jmem, jb.src, jb.dst, s.jbgd, jb.ts, *s.jsubs, *k,
        method=JaxTGN.ratio_contrast))(s.params, jkeeps)
    with torch.no_grad():
        pos, neg = s.tm.ratio_contrast(
            s.tfeats, s.tmem, _t(jb.src), _t(jb.dst), _t(s.jbgd), _t(jb.ts),
            *s.tsubs, *tkeeps)
        np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=2e-4,
                                   atol=1e-5)
        # one masked forward per ratio: dropped support edges become node 0
        for ri in range(len(ratios)):
            subs = [Subgraph(tuple(torch.where(keep[ri], nodes, 0)
                                   for keep, nodes in zip(keeps, sub.nodes)),
                             sub.eids, sub.ts)
                    for keeps, sub in zip(tkeeps, s.tsubs)]
            (p1, n1), _ = s.tm.contrast(
                s.tfeats, s.tmem, _t(jb.src), _t(jb.dst), _t(s.jbgd),
                _t(jb.ts), _t(jb.eidx), *subs, update_memory=False)
            np.testing.assert_allclose(pos[ri].numpy(), p1[:, 0].numpy(),
                                       rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(neg[ri].numpy(), n1[:, 0].numpy(),
                                       rtol=2e-4, atol=1e-5)
    assert not torch.allclose(pos[0], pos[-1])
