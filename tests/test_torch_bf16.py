"""bf16 projections (``compute_dtype``): the port at its default against
the JAX package at its default, on the CPU.

The JAX models default to ``compute_dtype=jnp.bfloat16`` and its drivers
never override it; the port's ``TGN`` now defaults to ``torch.bfloat16``
the same way. A toy TGN's explained contrast and one TGN train step, both
packages at bf16 with JAX's ``fused_attend`` in Pallas interpret mode
(float32 arithmetic inside, as the port's kernel and its plain version).
Tolerances: logits atol 2e-4, loss rtol 1e-5 (the port at bf16 is within
about 4e-7 and 6e-8). The float32 port, the parent's only form, misses
both: its logits are off by about 5e-3 and its loss by about 2e-4
(``CHANGES.md``, PR 6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_explain_base import (N, _jax_explained,
                                           _port_explained, _weights)
from tests.test_torch_explain_base import setup  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import jax_support_draws
from tests.test_torch_tgn import _np_tree, _t
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu.models.tgn import TGN as JaxTGN
from tempme_tpu.train import learn_tgn as JT
from tempme_tpu.train import loops as JL
from tempme_tpu_torch.models.tgn import TGN
from tempme_tpu_torch.train import learn_tgn as T
from tempme_tpu_torch.utils.convert import flax_to_state_dict


@pytest.fixture(scope="module")
def jax_bf16(setup):
    """JAX at its default bf16, ``fused_attend`` in interpret mode: the
    explained logits and one TGN train step's loss, with its batch and
    support draws."""
    s = setup
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TEMPME_PALLAS", "1")
        jm = JaxTGN(node_dim=12, edge_dim=6, num_nodes=s.tm.num_nodes,
                    n_layers=2, n_head=2, dropout=0.0)      # bf16 default
        w = _weights(9)
        pos, neg = _jax_explained(s, s.params, [jnp.asarray(x) for x in w],
                                  jm)
        dst = np.unique(s.ev.dst)
        jopt = optax.adam(1e-3)
        jstep = JT.make_tgn_train_step(jm, s.jg, s.jfeats, jnp.asarray(dst),
                                       N, jopt)
        state = JL.TrainState(s.params, jopt.init(s.params),
                              jax.random.PRNGKey(5))
        jb = s.batch(150, 8)
        k_samp = jax.random.split(state.key, 3)[1]     # the step's split
        _, _, aux = jstep(state, s.jmem, jb)
    return dict(w=w, pos=np.asarray(pos), neg=np.asarray(neg),
                loss=float(aux["loss"]), dst=dst, batch=jb,
                draws=jax_support_draws(k_samp, 8, 2, N, len(dst)))


@pytest.mark.parametrize("port_dtype", ["default", "float32"])
def test_bf16_contrast_and_train_step_match_jax(setup, jax_bf16, port_dtype):
    """The port at its default (bf16) agrees with JAX at its default within
    logits atol 2e-4 and loss rtol 1e-5; the float32 port (the parent's
    only form) misses both."""
    s, ref = setup, jax_bf16
    kw = {} if port_dtype == "default" else dict(compute_dtype=torch.float32)
    tm = TGN(12, 6, s.tm.num_nodes, dropout=0.0, device="cpu", **kw)
    tm.load_state_dict(flax_to_state_dict(_np_tree(s.params)))
    with torch.no_grad():
        pos, neg = _port_explained(s, tm, [torch.from_numpy(x)
                                           for x in ref["w"]])
    err = max(np.abs(pos.numpy() - ref["pos"]).max(),
              np.abs(neg.numpy() - ref["neg"]).max())
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    step = T.make_tgn_train_step(tm, s.tg, s.tfeats, _t(ref["dst"]), N, opt)
    _, aux = step(s.tmem, T.loops.Batch(*(_t(x) for x in ref["batch"])),
                  T.StepDraws(ref["draws"], None))
    loss_err = abs(float(aux["loss"]) - ref["loss"]) / abs(ref["loss"])
    print(f"port {port_dtype} vs JAX bf16: logits {err:.3e}, loss "
          f"{loss_err:.3e}")
    if port_dtype == "default":
        assert tm.attn_layers[0].attn.compute_dtype == torch.bfloat16
        assert err <= 2e-4 and loss_err <= 1e-5, (err, loss_err)
    else:
        assert err > 2e-4 and loss_err > 1e-5, (err, loss_err)
