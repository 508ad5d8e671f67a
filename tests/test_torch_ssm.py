"""The recurrent blocks of ``repro_torch.models.ssm`` (port queue item
5.4) against the reference's ``repro.models.ssm``, in float32 on seeded
inputs, with the reference's parameters carried across leaf by leaf
(rtol = atol = 1e-4 unless a line says otherwise):

* the cells (``_mlstm_cell``, ``_slstm_cell``) from seeded states, the
  gates and projections, the causal conv and the written-out gelu;
* the sequential forms, the step forms (six steps from a seeded state)
  and the chunked forms (seq 64, chunk 16: four chunks);
* inside the port: chunked == sequential at seq 512 with the default
  chunks (2 mLSTM chunks of 256, 4 Mamba2 chunks of 128) and step ==
  sequence, within the reference's own 2e-4 / 1e-3
  (``tests/test_attention_ssm.py``); a chunk that does not divide the
  sequence raises ``ValueError``;
* the step forms' priced ops (``estimator.capture``) in the reference's
  order, ops and shapes, the einsums' products with its (batch, m, n, k);
* the states, and the blocks' init (``f_bias`` 3, ``a_log`` 0,
  ``d_skip`` 1, the gates at 0.02).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import _flatten
from repro.core import estimator as ref_est
from repro.models import ssm as ref_ssm
from repro_torch.core import estimator
from repro_torch.models import ssm

TOL = dict(rtol=1e-4, atol=1e-4)
OWN = dict(rtol=1e-3, atol=2e-4)        # the reference's own tolerance
D, H, N, P, W = 32, 4, 8, 16, 4         # width, heads, state, headdim, conv
KW = dict(ssm_state=N, headdim=P)


@functools.cache
def _params(kind: str, d: int = D):
    """(the reference's params, the port's flat mapping of the same), made
    once a (kind, width): no test writes into them."""
    key = jax.random.PRNGKey(0)
    if kind == "mlstm":
        rp = ref_ssm.init_mlstm(key, d, H, jnp.float32)
    elif kind == "slstm":
        rp = ref_ssm.init_slstm(key, d, H, jnp.float32)
    else:
        rp = ref_ssm.init_mamba2(key, d, N, P, W, jnp.float32)
        # the init's constant leaves away from their init: the holds must
        # see each read
        rng = np.random.default_rng(3)
        rp = {**rp, **{k: jnp.asarray(rng.normal(0, 0.5, rp[k].shape),
                                      jnp.float32)
                       for k in ("dt_bias", "a_log", "d_skip")}}
    return rp, {k: torch.from_numpy(np.array(v)) for k, v in
                _flatten(rp).items()}


def _x(shape, seed=1, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _states_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in got:
        _close(got[k], want[k])


def _state(kind: str, b: int, seed: int = 5) -> dict:
    """A seeded state of ``kind`` (the stabilizer finite)."""
    rng = np.random.default_rng(seed)
    dk = D // H
    shapes = {"mlstm": {"C": (b, H, dk, dk), "m": (b, H), "n": (b, H, dk)},
              "slstm": {"c": (b, D), "h": (b, D), "m": (b, H), "n": (b, D)},
              "mamba2": {"conv": (b, W - 1, 2 * D),
                         "ssm": (b, 2 * D // P, P, N)}}[kind]
    st = {k: rng.standard_normal(s).astype(np.float32) * 0.5
          for k, s in shapes.items()}
    if "n" in st and kind == "slstm":
        st["n"] = np.abs(st["n"]) + 0.5
    return st


def _both(st: dict):
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v.copy()) for k, v in st.items()})


def test_cells_match_reference():
    b, dk = 3, D // H
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, H, dk)).astype(np.float32)
               for _ in range(3))
    i_pre, f_pre = (rng.standard_normal((b, H)).astype(np.float32)
                    for _ in range(2))
    rs, ts = _both(_state("mlstm", b))
    want_st, want = ref_ssm._mlstm_cell(rs, *map(jnp.asarray,
                                                 (q, k, v, i_pre, f_pre)))
    got_st, got = ssm._mlstm_cell(ts, *map(torch.from_numpy,
                                           (q, k, v, i_pre, f_pre)))
    _close(got, want)
    _states_close(got_st, want_st)
    z = rng.standard_normal((b, D)).astype(np.float32)
    rs, ts = _both(_state("slstm", b))
    want_st, want = ref_ssm._slstm_cell(rs, *map(jnp.asarray,
                                                 (z, i_pre, f_pre)), H)
    got_st, got = ssm._slstm_cell(ts, *map(torch.from_numpy,
                                           (z, i_pre, f_pre)), H)
    _close(got, want)
    _states_close(got_st, want_st)


def test_projections_conv_and_gelu_match_reference():
    x = _x((2, 9, D))
    rp, tp = _params("mlstm")
    for got, want in zip(ssm._mlstm_gates_qkv(torch.from_numpy(x), tp, H),
                         ref_ssm._mlstm_gates_qkv(jnp.asarray(x), rp, H)):
        _close(got, want)
    rp, tp = _params("mamba2")
    got = ssm._mamba_proj(torch.from_numpy(x), tp)
    want = ref_ssm._mamba_proj(jnp.asarray(x), rp, P)
    for g, w in zip(got, want):
        _close(g, w)
    xi = _x((2, 9, 2 * D), seed=2)
    _close(ssm._causal_conv_seq(torch.from_numpy(xi), tp["conv"]),
           ref_ssm._causal_conv_seq(jnp.asarray(xi), rp["conv"]))
    y = _x((4, 33), seed=3, scale=3.0)
    np.testing.assert_allclose(ssm.gelu(torch.from_numpy(y)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-6)


SEQ = {"mlstm": (ssm.mlstm_seq, ref_ssm.mlstm_seq, (H,), {}),
       "slstm": (ssm.slstm_seq, ref_ssm.slstm_seq, (H,), {}),
       "mamba2": (ssm.mamba2_seq, ref_ssm.mamba2_seq, (), KW)}


@pytest.mark.parametrize("kind", list(SEQ))
def test_sequential_forms_match_reference(kind):
    fn, ref_fn, args, kw = SEQ[kind]
    rp, tp = _params(kind)
    x = _x((2, 24, D))
    _close(fn(torch.from_numpy(x), tp, *args, **kw),
           ref_fn(jnp.asarray(x), rp, *args, **kw))


STEP = {"mlstm": (ssm.mlstm_step, ref_ssm.mlstm_step, (H,), {}),
        "slstm": (ssm.slstm_step, ref_ssm.slstm_step, (H,), {}),
        "mamba2": (ssm.mamba2_step, ref_ssm.mamba2_step, (), KW)}


@pytest.mark.parametrize("kind", list(STEP))
def test_step_forms_match_reference(kind):
    fn, ref_fn, args, kw = STEP[kind]
    rp, tp = _params(kind)
    rs, ts = _both(_state(kind, 3))
    x = _x((3, 6, D))
    for t in range(6):
        want, rs = ref_fn(jnp.asarray(x[:, t:t + 1]), rp, rs, *args, **kw)
        got, ts = fn(torch.from_numpy(x[:, t:t + 1]), tp, ts, *args, **kw)
        _close(got, want)
        _states_close(ts, rs)


CHUNKED = {"mlstm": (ssm.mlstm_seq_chunked, ref_ssm.mlstm_seq_chunked, (H,),
                     {}),
           "mamba2": (ssm.mamba2_seq_chunked, ref_ssm.mamba2_seq_chunked, (),
                      KW)}


@pytest.mark.parametrize("kind", list(CHUNKED))
def test_chunked_forms_match_reference(kind):
    fn, ref_fn, args, kw = CHUNKED[kind]
    rp, tp = _params(kind)
    x = _x((2, 64, D))
    _close(fn(torch.from_numpy(x), tp, *args, chunk=16, **kw),
           ref_fn(jnp.asarray(x), rp, *args, chunk=16, **kw))


@pytest.mark.parametrize("kind", list(CHUNKED))
def test_chunked_equals_sequential_over_several_chunks(kind):
    """seq 512 at the default chunks: 2 mLSTM chunks of 256, 4 Mamba2
    chunks of 128, each carrying its state into the next."""
    fn, _, args, kw = CHUNKED[kind]
    seq_fn = SEQ[kind][0]
    _, tp = _params(kind, d=16)
    x = torch.from_numpy(_x((1, 512, 16), scale=2.0))
    got = fn(x, tp, *args, **kw)
    want = seq_fn(x, tp, *args, **kw)
    torch.testing.assert_close(got, want, **OWN)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("kind", list(STEP))
def test_step_equals_sequence_inside_the_port(kind):
    fn, _, args, kw = STEP[kind]
    seq_fn = SEQ[kind][0]
    _, tp = _params(kind)
    x = torch.from_numpy(_x((2, 12, D)))
    st = {"mlstm": lambda: ssm.mlstm_state(2, H, D // H, D // H),
          "slstm": lambda: ssm.slstm_state(2, D, H),
          "mamba2": lambda: ssm.mamba2_state(2, 2 * D // P, P, N, W,
                                             2 * D)}[kind]()
    outs = []
    for t in range(x.shape[1]):
        o, st = fn(x[:, t:t + 1], tp, st, *args, **kw)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), seq_fn(x, tp, *args, **kw),
                               **OWN)


def test_a_chunk_that_does_not_divide_raises():
    _, tp = _params("mlstm")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.mlstm_seq_chunked(torch.zeros(1, 48, D), tp, H, chunk=32)
    _, tp = _params("mamba2")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm.mamba2_seq_chunked(torch.zeros(1, 40, D), tp, chunk=16, **KW)


def _ref_priced(fn, *args):
    closed = jax.make_jaxpr(fn)(*args)
    rows = []
    for eqn, _ in ref_est.iter_eqns(closed.jaxpr):
        kind = ref_est.node_kind(eqn.primitive.name)
        if kind == "matmul":
            rows.append(("matmul", ref_est.dot_general_dims(eqn)))
        elif kind:
            rows.append((eqn.primitive.name,
                         tuple(eqn.outvars[0].aval.shape)))
    return rows


def _port_priced(fn, *args):
    cap = estimator.capture(fn, *args)
    rows = []
    for node, _ in estimator.iter_nodes(cap.gm):
        kind = estimator.node_kind(node.target)
        if kind == "matmul":
            rows.append(("matmul", estimator.mm_dims(node)))
        elif kind:
            rows.append((estimator.op_name(node.target),
                         estimator.shape_of(node)))
    return rows


# the step's priced nodes: (products, eltwise ops) — the reference's graph
# of one decode step (its graph: 67 nodes an xlstm unit, 21 a Mamba2 layer)
PRICED = {"mlstm": (10, 26), "slstm": (7, 24), "mamba2": (7, 14)}


@pytest.mark.parametrize("kind", list(STEP))
def test_step_priced_ops_equal_reference(kind):
    """Batch 8, so that each product's m and n tell its operands apart
    (the Mamba2 conv's einsum: the filter the left operand, batch over the
    channels)."""
    fn, ref_fn, args, kw = STEP[kind]
    rp, tp = _params(kind)
    rs, ts = _both(_state(kind, 8))
    x = _x((8, 1, D))
    want = _ref_priced(lambda x, p, s: ref_fn(x, p, s, *args, **kw),
                       jnp.asarray(x), rp, rs)
    meta = {k: torch.empty(v.shape, device="meta") for k, v in tp.items()}
    mst = {k: torch.empty(v.shape, device="meta") for k, v in ts.items()}
    got = _port_priced(lambda x, p, s: fn(x, p, s, *args, **kw),
                       torch.empty(x.shape, device="meta"), meta, mst)
    assert got == want
    assert (sum(r[0] == "matmul" for r in got),
            sum(r[0] != "matmul" for r in got)) == PRICED[kind]
    if kind == "mamba2":
        assert ("matmul", (2 * D, 1, 8, W)) in got


def test_states_match_reference():
    dk = D // H
    for got, want in (
            (ssm.mlstm_state(3, H, dk, dk), ref_ssm.mlstm_state(3, H, dk, dk)),
            (ssm.slstm_state(3, D, H), ref_ssm.slstm_state(3, D, H)),
            (ssm.mamba2_state(3, 2 * D // P, P, N, W, 2 * D),
             ref_ssm.mamba2_state(3, 2 * D // P, P, N, W, 2 * D))):
        assert list(got) == sorted(want)
        for k in got:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_block_init_takes_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    d = 128
    blocks = {"mlstm": ssm.mlstm_block(d, 4, 1e-5, torch.float32, "cpu"),
              "slstm": ssm.slstm_block(d, 4, 1e-5, torch.float32, "cpu"),
              "mamba2": ssm.mamba2_block(d, 16, 64, 4, 1e-5,
                                         torch.float32, "cpu")}
    for kind, blk in blocks.items():
        blk.init(gen)
        for m in blk.modules():
            if m is not blk and hasattr(m, "init"):
                m.init(gen)
        rp, _ = _params(kind, d=d) if kind != "mamba2" else (
            ref_ssm.init_mamba2(jax.random.PRNGKey(0), d, 16, 64, 4,
                                jnp.float32), None)
        flat = _flatten(rp)
        assert sorted(blk.leaves) == sorted(flat)
        for name in blk.leaves:
            got, want = blk[name], np.asarray(flat[name])
            assert tuple(got.shape) == want.shape
            if want.std() == 0:            # a constant: the same one
                assert bool((got == float(want.flat[0])).all()), name
            else:                          # a normal draw at its scale
                assert abs(float(got.std()) / want.std() - 1) < 0.15, name
