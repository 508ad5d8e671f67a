"""The mixture-of-experts block (``models/moe.py``, port queue item 5.3)
against the reference's ``repro.models.moe``, in float32, at the smoke
configs of granite-moe-1b-a400m and llama4-maverick-400b-a17b (with its
shared expert), at a decode shape (B 8, S 1) and a sequence shape (B 2,
S 128):

* the output within rtol = atol = 1e-4;
* the dispatch exactly: the gate indices, the keep mask, the slot ->
  token map and the slot-valid mask, read from the reference's own
  evaluation of its jaxpr (``_ref_internals``);
* a capacity that drops tokens (``capacity_factor=0.1``, one group): the
  same assignments dropped;
* a router whose probabilities all tie (zero weights): the reference's
  ``lax.top_k`` order, the lower index first;
* the reference's dense oracle (``test_moe_equals_dense_when_topk_is_all``);
* ``capacity``, ``_n_groups`` and ``aux_load_balance_loss``.
"""

import dataclasses

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b")
SHAPES = {"decode": (8, 1), "sequence": (2, 128)}


def _params(cfg, seed=0):
    """The reference's init (jnp) and the same values as torch tensors."""
    p = ref_moe.init_moe(jax.random.PRNGKey(seed), cfg.d_model,
                         cfg.n_experts, cfg.moe_d_ff, jnp.float32,
                         shared_expert=cfg.shared_expert,
                         shared_d_ff=cfg.d_ff)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _ref_internals(x, p, cfg) -> dict:
    """The reference's ``moe_block`` evaluated equation by equation over
    its jaxpr, with the values the dispatch is made of: the gate indices
    (``top_k``), the keep mask (the first ``lt``), the slot -> token map
    and the slot-valid mask (the two ``scatter``s, the dump lane cut)."""
    closed = jax.make_jaxpr(lambda x, p: ref_moe.moe_block(x, p, cfg))(x, p)
    env = {}

    def read(v):
        return v.val if isinstance(v, jax.extend.core.Literal) else env[v]

    for v, val in zip(closed.jaxpr.constvars, closed.consts):
        env[v] = val
    for v, val in zip(closed.jaxpr.invars, jax.tree.leaves((x, p))):
        env[v] = val
    seen: dict[str, list] = {}
    for eqn in closed.jaxpr.eqns:
        subfuns, params = eqn.primitive.get_bind_params(eqn.params)
        outs = eqn.primitive.bind(*subfuns, *map(read, eqn.invars), **params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        for v, o in zip(eqn.outvars, outs):
            env[v] = o
        seen.setdefault(eqn.primitive.name, []).append(outs)
    (slot_token,), (slot_valid,) = seen["scatter"]
    return dict(gate_idx=np.asarray(seen["top_k"][0][1]),
                keep=np.asarray(seen["lt"][0][0]),
                slot_token=np.asarray(slot_token)[:-1],
                slot_valid=np.asarray(slot_valid)[:-1],
                out=np.asarray(read(closed.jaxpr.outvars[0])))


def _assert_dispatch_equal(cfg, rcfg, x, rp, tp):
    want = _ref_internals(jnp.asarray(x), rp, rcfg)
    got = moe.route(torch.from_numpy(x), tp["router"], cfg)
    grp, tl = got["grp"], got["tl"]
    np.testing.assert_array_equal(
        got["flat_e"].numpy().reshape(grp, tl, cfg.top_k), want["gate_idx"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_array_equal(got["slot_token"].numpy().reshape(-1),
                                  want["slot_token"])
    np.testing.assert_array_equal(got["slot_valid"].numpy().reshape(-1),
                                  want["slot_valid"])
    out = moe.moe_block(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(out.numpy(), want["out"], **TOL)
    return got


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, shape):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, tp = _params(cfg)
    x = _x(cfg, *SHAPES[shape])
    got = _assert_dispatch_equal(cfg, rcfg, x, rp, tp)
    np.testing.assert_allclose(
        moe.moe_block(torch.from_numpy(x), tp, cfg).numpy(),
        np.asarray(ref_moe.moe_block(jnp.asarray(x), rp, rcfg)), **TOL)
    assert ("shared_expert" in tp) == cfg.shared_expert
    if shape == "decode":
        # one token a group: its k distinct experts each have a slot
        assert got["tl"] == 1 and bool(got["keep"].all())


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_the_reference_tokens(arch):
    """One group of 256 tokens at ``capacity_factor=0.1``: each expert
    keeps its first C assignments in token-major, k-minor order and
    drops the rest, the same ones on both sides."""
    changes = dict(capacity_factor=0.1, moe_groups=1)
    rcfg = dataclasses.replace(ref_smoke_config(arch), **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    rp, tp = _params(cfg, 2)
    x = _x(cfg, 2, 128, 3)
    got = _assert_dispatch_equal(cfg, rcfg, x, rp, tp)
    keep = got["keep"].numpy()
    assert got["c"] == moe.capacity(256, cfg.n_experts, cfg.top_k, 0.1)
    assert 0 < (~keep).sum() < keep.size
    # an expert's kept assignments are its first C
    flat_e = got["flat_e"].numpy()[0]
    for e in range(cfg.n_experts):
        mine = keep[0][flat_e == e]
        assert mine[:got["c"]].all() and not mine[got["c"]:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_takes_the_reference_indices(arch):
    """A zero router ties every probability: ``lax.top_k`` picks the
    lower indices first, and so does the port (``torch.topk`` need
    not)."""
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp, tp = _params(cfg, 4)
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    got = _assert_dispatch_equal(cfg, rcfg, _x(cfg, 2, 128, 5), rp, tp)
    assert (got["flat_e"].numpy().reshape(-1, cfg.top_k)
            == np.arange(cfg.top_k)).all()
    # ties that are not at the front: the reference's order, not topk's
    probs = torch.tensor([0.1, 0.3, 0.3, 0.2, 0.3, 0.0, 0.3, 0.3] * 4)
    _, idx = moe.top_k(probs, 8)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), 8)
    assert idx.tolist() == np.asarray(want).tolist() == [
        1, 2, 4, 6, 7, 9, 10, 12]


def test_moe_equals_dense_when_topk_is_all():
    """The reference's oracle: with ``top_k = n_experts`` and ample
    capacity the block is the softmax-weighted sum of every expert."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              n_experts=4, top_k=4, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg.d_model, 4, cfg.moe_d_ff, torch.float32,
                     "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)) * 0.3).float()
    got = moe.moe_block(x, p, cfg).reshape(-1, cfg.d_model)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax((xf @ p["router"]).float(), -1)
    want = torch.zeros_like(xf)
    for ei in range(4):
        g = torch.nn.functional.silu(xf @ p["w_gate"][ei]) * (
            xf @ p["w_up"][ei])
        want = want + probs[:, ei:ei + 1] * (g @ p["w_down"][ei])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-2)


def test_sizes_and_aux_loss_equal_reference():
    for tl in (1, 3, 8, 16, 100, 4096):
        for e, k, f in ((4, 2, 1.25), (32, 8, 1.25), (128, 1, 1.25),
                        (4, 2, 0.1)):
            assert moe.capacity(tl, e, k, f) == ref_moe.capacity(tl, e, k, f)
    for arch in ARCHS:
        cfg, rcfg = get_smoke_config(arch), ref_smoke_config(arch)
        for t in (1, 8, 12, 256, 4096):
            assert moe._n_groups(cfg, t) == ref_moe._n_groups(rcfg, t)
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 16, 4)).astype(np.float32)
    idx = rng.integers(0, 4, (2, 16, 2)).astype(np.int32)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(idx), 4)
    want = ref_moe.aux_load_balance_loss(jnp.asarray(logits),
                                         jnp.asarray(idx), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_module_holds_the_reference_tree():
    """``MoE``'s parameters are the reference's ``moe`` subtree, and the
    init draws the reference's distributions: the router at 0.02, the
    experts at fan_in^-0.5 with the fan-in the expert count."""
    cfg = get_smoke_config("llama4-maverick-400b-a17b")
    m = moe.MoE(cfg, torch.float32, "cpu")
    m.init(torch.Generator().manual_seed(0))
    m.shared_expert.init(torch.Generator().manual_seed(1))
    tree = m.tree()
    assert sorted(tree) == ["router", "shared_expert", "w_down", "w_gate",
                            "w_up"]
    assert tuple(tree["w_down"].shape) == (cfg.n_experts, cfg.moe_d_ff,
                                           cfg.d_model)
    assert abs(float(tree["router"].std()) - 0.02) < 0.005
    assert abs(float(tree["w_gate"].std()) - cfg.n_experts ** -0.5) < 0.05
    x = torch.from_numpy(_x(cfg, 2, 4))
    assert torch.equal(m(x), moe.moe_block(x, tree, cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_published_parameter_count_on_meta(arch):
    """The published configs' modules on meta tensors hold the
    reference's ``param_count`` (which leaves out the final norm): granite
    1.33 B, maverick 398 B with its interleaved units."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config
    from repro_torch.models import DecoderLM
    cfg = get_config(arch)
    model = DecoderLM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + cfg.d_model
    assert cfg.param_count() == ref_config(arch).param_count()
    assert n - cfg.d_model == {"granite-moe-1b-a400m": 1_334_627_328,
                               "llama4-maverick-400b-a17b": 397_691_944_960
                               }[arch]
