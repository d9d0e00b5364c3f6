"""Expert parallelism's FFN against the JAX package: `moe.moe_ffn` with
``ep`` over a 4 x 1 gloo mesh (the worker, `ep_worker`, lives in the
JAX-free tests/test_torch_mesh.py; one torch thread a rank, a join
timeout) against JAX ``moe_ffn`` with ``ep_axis`` under ``jax.vmap``
over 4 "devices", at ``capacity_factor`` 1.25: E = 8 >= D (two experts
a rank, drops) and E = 2 < D (a rank takes a token share of one
expert, ``cap`` rounded up to a multiple of 2); outputs, aux, x's
gradients and the weights' gradients summed over the ranks (a rank's
gradient of an expert it does not own is zero); the ``ep`` calls and
their bytes, two all-to-alls forward and two backward.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jget
from repro.models import moe as JM
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.mesh import spawn
from repro_torch.models.moe import capacity
from test_torch_mesh import SPAWN_TIMEOUT, ep_worker

TOL = 1e-5


# ---------------------------------------------------------------------------
# the expert-parallel FFN
# ---------------------------------------------------------------------------

EP_RANKS = 4
# (experts, top_k, tokens a rank): E >= D with drops; E < D, where the
# capacity ceil(7 x 2 / 2 x 1.25) = 9 rounds up to 10
EP_CASES = [(8, 2, 12), (2, 2, 7)]


def _ep_case(e, k, t, seed):
    jc = jget("mixtral-8x22b", smoke=True).with_(
        n_experts=e, top_k=k, capacity_factor=1.25)
    p = jax.tree.map(np.asarray, JM.init_moe(
        jax.random.PRNGKey(seed), jc.d_model, e, jc.moe_d_ff))
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((EP_RANKS, 1, t, jc.d_model))
         + rng.standard_normal(jc.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return jc, p, x, g


def _jax_ep(jc, p, x, g):
    """JAX's expert-parallel FFN over EP_RANKS "devices" (``vmap`` with
    an axis name): outputs, aux, and the gradients of sum(out * g)
    summed over the devices, x's per device."""
    def fwd(p, x):
        return jax.vmap(lambda xx: JM.moe_ffn(
            p, xx, top_k=jc.top_k, capacity_factor=jc.capacity_factor,
            ep_axis="data", ep_size=EP_RANKS), axis_name="data")(x)
    y, aux = jax.jit(fwd)(p, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(fwd(p, x)[0] * g),
                              argnums=(0, 1)))(p, x)
    return y, aux, gp, gx


def test_expert_parallel_ffn_matches_jax(tmp_path):
    cases, want = [], []
    for i, (e, k, t) in enumerate(EP_CASES):
        jc, p, x, g = _ep_case(e, k, t, i)
        cases.append({"cfg": tget("mixtral-8x22b", smoke=True).with_(
            n_experts=e, top_k=k, capacity_factor=1.25),
            "weights": p, "x": x, "g": g})
        want.append(_jax_ep(jc, p, x, g))
    out = spawn(ep_worker, EP_RANKS, ({"cases": cases},),
                timeout=SPAWN_TIMEOUT, store_dir=str(tmp_path))
    for c, case, (y, aux, gp, gx) in zip(range(len(cases)), cases, want):
        cfg = case["cfg"]
        t = case["x"].shape[2]
        cap = capacity(t, cfg.top_k, cfg.n_experts, 1.25, EP_RANKS)
        assert cap % (EP_RANKS // np.gcd(cfg.n_experts, EP_RANKS)) == 0
        one = (EP_RANKS - 1) * cfg.n_experts * cap // EP_RANKS \
            * cfg.d_model * 4
        for r in range(EP_RANKS):
            got = out[r][c]
            np.testing.assert_allclose(got["y"], y[r], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(got["aux"], aux[r], rtol=TOL)
            np.testing.assert_allclose(got["x_grad"], gx[r], rtol=TOL,
                                       atol=TOL)
            assert got["calls"] == [("ep", "all-to-all", "f32", one)] * 4
            # the experts this rank does not compute get no gradient
            ne = max(cfg.n_experts // EP_RANKS, 1)
            start = r * cfg.n_experts // EP_RANKS
            others = np.delete(got["grads"]["w_up"],
                               range(start, start + ne), axis=0)
            assert not others.any()
        for name in ("router", "w_gate", "w_up", "w_down"):
            total = sum(out[r][c]["grads"][name] for r in range(EP_RANKS))
            np.testing.assert_allclose(total, gp[name], rtol=1e-4,
                                       atol=1e-5 * np.abs(gp[name]).max(),
                                       err_msg=name)
