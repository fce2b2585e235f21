"""The port's TGN serving path against the JAX package on the CPU.

The JAX model runs with ``compute_dtype=float32``; its weights are carried
into the port by ``utils/convert.py``. Logits and every field of the carried
memory state agree to rtol 2e-4 and atol 1e-5: the float32 sums run in
another order, and ``cos`` of large time arguments (time deltas times the
encoder's unit frequency) loses digits in both packages. Sampled supports
and ``msg_valid`` agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_graph_sampler import (jax_support_draws,
                                            to_torch_events)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.data.graph import build_temporal_graph as jax_build_graph
from tempme_tpu.models.common import Features as JaxFeatures
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu.models.tgn import init_memory_state as jax_init_memory
from tempme_tpu.train import learn_tgn as JT
from tempme_tpu.train import loops as JL
from tempme_tpu.utils.checkpoint import load_params, load_meta
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.models.tgn import TGN, TGNMemoryState, init_memory_state
from tempme_tpu_torch.ops.sampler import Subgraph
from tempme_tpu_torch.train import learn_tgn as T
from tempme_tpu_torch.utils.convert import flax_to_state_dict

RTOL, ATOL = 2e-4, 1e-5
CKPT = "params/tgnn/tgn_uslegis_sampled.msgpack"


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_memory(mem):
    return TGNMemoryState(*(_t(x) for x in mem))


def _assert_memory_close(port, ref):
    for name in ref._fields:
        p, r = getattr(port, name).numpy(), np.asarray(getattr(ref, name))
        if r.dtype == bool:
            np.testing.assert_array_equal(p, r, err_msg=name)
        else:
            np.testing.assert_allclose(p, r, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


class Setup:
    """A small stream, both graphs, features and both models with the same
    weights."""

    def __init__(self, node_dim=12, edge_dim=6, num_nodes=30, num_events=300,
                 seed=0, params=None, num_model_nodes=None):
        self.ev = make_events(num_events=num_events, num_nodes=num_nodes,
                              seed=seed)
        nn_ = num_model_nodes or self.ev.num_nodes
        self.jg = jax_build_graph(self.ev, num_nodes=nn_)
        self.tg = build_temporal_graph(to_torch_events(self.ev), num_nodes=nn_,
                                       device="cpu")
        r = np.random.RandomState(seed + 1)
        node = r.randn(nn_, node_dim).astype(np.float32)
        edge = r.randn(self.jg.num_edges, edge_dim).astype(np.float32)
        node[0] = edge[0] = 0.0
        self.jfeats = JaxFeatures(jnp.asarray(node), jnp.asarray(edge))
        self.tfeats = Features(_t(node), _t(edge))
        self.jm = JaxTGN(node_dim=node_dim, edge_dim=edge_dim, num_nodes=nn_,
                         n_layers=2, n_head=2, dropout=0.0,
                         compute_dtype=jnp.float32)
        self.jmem = jax_init_memory(nn_, self.jm.memory_dim,
                                    self.jm.raw_message_dim)
        self._jax_contrast = jax.jit(
            lambda p, *a: self.jm.apply(p, *a, method=JaxTGN.contrast))
        self._jax_support = jax.jit(JL.sample_support,
                                    static_argnums=(4, 5, 6))
        if params is None:
            b = self.batch(0, 8)
            _, s0, s1, s2 = self._jax_support(
                self.jg, jax.random.PRNGKey(0), b, jnp.arange(1, 5), 2, 3,
                True)
            params = jax.jit(self.jm.init)(
                jax.random.PRNGKey(seed), self.jfeats, self.jmem, b.src,
                b.dst, b.dst, b.ts, b.eidx, s0, s1, s2)
        self.params = params
        self.tm = TGN(node_dim, edge_dim, nn_, device="cpu",
                      compute_dtype=torch.float32)
        self.tm.load_state_dict(flax_to_state_dict(_np_tree(params)))
        self.tmem = init_memory_state(nn_, self.tm.memory_dim,
                                      self.tm.raw_message_dim, device="cpu")

    def batch(self, start, b):
        s = slice(start, start + b)
        return JL.Batch(jnp.asarray(self.ev.src[s]), jnp.asarray(self.ev.dst[s]),
                        jnp.asarray(self.ev.ts[s]),
                        jnp.asarray(self.ev.e_idx[s]), jnp.ones(b, bool))

    def contrast_both(self, jmem, tmem, jb, key, n):
        dst_table = jnp.asarray(np.unique(self.ev.dst))
        bgd, ss, st, sb = self._jax_support(self.jg, key, jb, dst_table, 2,
                                            n, False)
        (pos_r, neg_r), jmem = self._jax_contrast(
            self.params, self.jfeats, jmem, jb.src, jb.dst, bgd, jb.ts,
            jb.eidx, ss, st, sb)
        subs = [Subgraph(*(tuple(_t(x) for x in f) for f in s))
                for s in (ss, st, sb)]
        (pos, neg), tmem = self.tm.contrast(
            self.tfeats, tmem, _t(jb.src), _t(jb.dst), _t(bgd), _t(jb.ts),
            _t(jb.eidx), *subs)
        return (pos, neg), tmem, (pos_r, neg_r), jmem


def test_contrast_three_batches_match_jax():
    s = Setup()
    jmem, tmem = s.jmem, s.tmem
    with torch.no_grad():
        for i in range(3):
            (pos, neg), tmem, (pos_r, neg_r), jmem = s.contrast_both(
                jmem, tmem, s.batch(40 + 10 * i, 10), jax.random.PRNGKey(i), 4)
            np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r),
                                       rtol=RTOL, atol=ATOL)
            _assert_memory_close(tmem, jmem)
    assert tmem.msg_valid.any() and (tmem.memory != 0).any()


def _jax_eval_draws(seed, n_batches, b, n, num_dst):
    key = jax.random.PRNGKey(seed)
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        yield jax_support_draws(sub, b, 2, n, num_dst)


def test_evaluate_tgn_matches_jax():
    s = Setup(seed=1)
    split = s.ev.select(np.arange(len(s.ev)) >= 240)   # 60 events
    bs, n = 16, 3                                       # last batch padded
    dst_table = np.unique(s.ev.dst)
    jstep = JT.make_tgn_eval_step(s.jm, s.jg, s.jfeats, jnp.asarray(dst_table),
                                  n)
    ref, jmem = JT.evaluate_tgn(jstep, s.params, s.jmem, split, bs,
                                return_memory=True)
    tstep = T.make_tgn_eval_step(s.tm, s.tg, s.tfeats, _t(dst_table), n)
    draws = _jax_eval_draws(0, -(-len(split) // bs), bs, n, len(dst_table))
    out, tmem = T.evaluate_tgn(tstep, s.tmem, to_torch_events(split), bs,
                               draws=draws)
    for name in ("ap", "auc", "acc"):
        assert abs(out[name] - ref[name]) <= 1e-6, (name, out, ref)
    _assert_memory_close(tmem, jmem)


def test_uslegis_checkpoint_forward_at_full_width():
    meta = load_meta(CKPT)
    assert (meta["node_dim"], meta["n_head"], meta["memory_updater"],
            meta["aggregator"], meta["message_function"],
            meta["embedding_module"]) == (172, 2, "gru", "last", "mlp",
                                          "graph_attention")
    nodes = meta["num_nodes"]
    s = Setup(node_dim=meta["node_dim"], edge_dim=meta["edge_dim"],
              num_nodes=nodes, num_events=200, seed=4, num_model_nodes=nodes)
    blob = load_params(CKPT, {"params": s.params, "memory": s.jmem})
    s.params = blob["params"]
    s.tm.load_state_dict(flax_to_state_dict(_np_tree(s.params)))
    jmem = s.jmem._replace(**{k: jnp.asarray(v)
                              for k, v in blob["memory"]._asdict().items()})
    tmem = _port_memory(jmem)
    with torch.no_grad():
        (pos, neg), tmem, (pos_r, neg_r), jmem = s.contrast_both(
            jmem, tmem, s.batch(100, 8), jax.random.PRNGKey(9), 5)
    assert s.tm.attn_layers[0].attn.d_k == 172
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(neg.numpy(), np.asarray(neg_r), rtol=RTOL,
                               atol=ATOL)
    _assert_memory_close(tmem, jmem)


def test_unported_variant_names_roadmap_item():
    """The variants (item A4) are ported (``tests/test_torch_tgn_variants
    .py`` holds them against JAX); unknown values raise, as in JAX."""
    TGN(8, 4, 10, memory_updater="rnn", device="cpu")
    with pytest.raises(ValueError, match="memory_updater"):
        TGN(8, 4, 10, memory_updater="lstm", device="cpu")
