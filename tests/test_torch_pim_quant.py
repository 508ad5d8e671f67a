"""The port's quantized weight datapath against the reference's.

The weight half of ``core.quant``, K5 (``pim_matmul_grouped_q``) with its
VJP, the quantized placement and schedule, and LeNet-5 served and trained
through the mapper on every sub-fp32 weight grid (int8, fp8_e4m3,
fp8_e5m2, fp16), on the CPU, where the wrappers run their plain versions.
The reference cannot run a placed quantized schedule in this environment
(its lowering calls ``jax.util``, which this jax lacks), so the oracles
are the reference's quantizer run eagerly (codes and scales bit-equal),
its K5 in interpret mode, its planning (node for node), and
``jax.jit(lenet_apply)`` over weights that its own ``fake_quant``
computed outside ``jit``. The train step, whose products read
activations as stationary operands too, is held to the port's plain
oracle ``run_fake_quant_plain`` (native ops over fake-quant operands).

Tolerances: the quantizer bit for bit; K5 against the Pallas kernel at
K1's rtol = atol = 1e-5 (the two sides sum each product in another
order); K5 equal to K1 on ``q * s`` bit for bit; the compiled program
equal to the per-block executor bit for bit on every grid; logits within
the mapper's verify tolerance, 1e-4; int8 training losses within 2% of
fp32, the reference's own contract.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import mapper as ref_mapper
from repro.configs.lenet5 import CONFIG as REF_CONFIG
from repro.core import quant as ref_quant
from repro.data import DigitsDataset as RefDigits
from repro.models import lenet as ref_lenet
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import mapper, obs
from repro_torch.checkpoint import lenet_params_from_reference
from repro_torch.configs import LENET5
from repro_torch.core import quant
from repro_torch.data import DigitsDataset, make_digits
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pim_mac import (pim_matmul_grouped,
                                         pim_matmul_grouped_q)
from repro_torch.mapper import lowering
from repro_torch.mapper.executor import run_fake_quant_plain
from repro_torch.models import lenet
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig

# the reference module (``repro.kernels.pim_mac`` the attribute is the
# function of that name)
ref_kernels = importlib.import_module("repro.kernels.pim_mac")

QDTYPES = ("int8", "fp8_e4m3", "fp8_e5m2", "fp16")
MM_TOL = dict(rtol=1e-5, atol=1e-5)        # K1's, test_torch_pim_kernels
TOL = dict(rtol=1e-4, atol=1e-4)           # the mapper's verify


def _weights(seed: int, *shape) -> np.ndarray:
    """Normal values over six decades of scale per column, with an
    all-zero column, exact zeros, and values at the grids' edges."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape) * 10.0 ** rng.integers(-4, 3,
                                                          shape[-1])
    w = w.astype(np.float32)
    w[..., 0] = 0.0
    w.reshape(-1)[::7] = 0.0
    w.reshape(-1)[1::11] *= 1e-30
    return w


def _bits(x) -> np.ndarray:
    """A tensor's or array's raw bits (int16 codes read as uint16)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


# ---------------------------------------------------------------------------
# core.quant, the weight half: bit-equal to the reference's
# ---------------------------------------------------------------------------


# one shape for every quantizer test: the reference's eager ops compile
# once per shape
SHAPE = (3, 96, 40)


@pytest.mark.parametrize("dtype", QDTYPES + ("fp32",))
@pytest.mark.parametrize("axis", [1, -1])
def test_quantize_axis_fake_quant_layer_error_bit_equal(dtype, axis):
    w = _weights(len(dtype) + axis, *SHAPE)
    q, s = quant.quantize_axis(torch.from_numpy(w), dtype, axis)
    rq, rs = ref_quant.quantize_axis(jnp.asarray(w), dtype, axis)
    assert np.array_equal(_bits(q), _bits(rq))
    assert np.array_equal(_bits(s), _bits(rs))
    assert np.array_equal(
        _bits(quant.fake_quant(torch.from_numpy(w), dtype, axis)),
        _bits(ref_quant.fake_quant(jnp.asarray(w), dtype, axis)))
    err = quant.layer_error(torch.from_numpy(w), dtype, axis)
    assert err.shape == () and np.array_equal(
        _bits(err), _bits(ref_quant.layer_error(jnp.asarray(w), dtype,
                                                axis)))
    assert float(err) <= quant.layer_error_budget(dtype) * (1 + 1e-6)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_ste_values_and_straight_through_gradient(dtype):
    w = _weights(7, *SHAPE)
    ct = np.random.default_rng(8).standard_normal(w.shape).astype(
        np.float32)
    wt = torch.from_numpy(w).requires_grad_(True)
    q, s = quant.quantize_ste(wt, dtype, 1)
    assert not s.requires_grad            # the scale's cotangent is dropped
    (dw,) = torch.autograd.grad((q * torch.from_numpy(ct)).sum(), wt)
    rq, rs = ref_quant.quantize_ste(jnp.asarray(w), dtype, 1)
    rdw = jax.grad(lambda x: jnp.sum(
        ref_quant.quantize_ste(x, dtype, 1)[0] * ct))(jnp.asarray(w))
    assert np.array_equal(_bits(q.detach()), _bits(rq))
    assert np.array_equal(_bits(s), _bits(rs))
    assert np.array_equal(_bits(dw), _bits(rdw))       # dq / scale
    assert torch.equal(dw, torch.from_numpy(ct) / s)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_blockwise_round_trip_bit_equal(dtype):
    x = _weights(3, 37, 29)                 # 1073 values: a ragged block
    codes, scale = quant.quantize_blockwise(torch.from_numpy(x), dtype)
    rcodes, rscale = ref_quant.quantize_blockwise(jnp.asarray(x), dtype)
    assert codes.shape == (5, quant.BLOCK) and quant.BLOCK == ref_quant.BLOCK
    assert np.array_equal(_bits(codes), _bits(rcodes))
    assert np.array_equal(_bits(scale), _bits(rscale))
    back = quant.dequantize_blockwise(codes, scale, torch.from_numpy(x),
                                      dtype)
    rback = ref_quant.dequantize_blockwise(rcodes, rscale, jnp.asarray(x),
                                           dtype)
    assert back.shape == x.shape
    assert np.array_equal(_bits(back), _bits(rback))


# ---------------------------------------------------------------------------
# K5's plain version and its VJP
# ---------------------------------------------------------------------------

# (G, col_groups, M, K, N)
K5_CASES = [(1, 1, 128, 128, 128), (2, 2, 128, 128, 128),
            (4, 4, 128, 256, 128), (3, 1, 256, 256, 128)]


def _k5_operands(case, dtype, seed):
    g, cg, m, k, n = case
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((g // cg, m, k)).astype(np.float32)
    w = rng.standard_normal((g, k, n)).astype(np.float32)
    q, s = quant.quantize_axis(torch.from_numpy(w), dtype, 1)
    return a, w, q, s


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", K5_CASES, ids=str)
def test_plain_k5_matches_pallas_kernel_and_equals_k1(case, dtype):
    g, cg, m, k, n = case
    a, _, q, s = _k5_operands(case, dtype, sum(case))
    want = ref_kernels.pim_matmul_grouped_q(
        jnp.asarray(a), jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
        col_groups=cg, interpret=True)
    got = pim_matmul_grouped_q(torch.from_numpy(a), q, s, col_groups=cg)
    assert got.shape == (g, m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MM_TOL)
    assert torch.equal(got, pim_matmul_grouped(torch.from_numpy(a), q * s,
                                               col_groups=cg))
    assert torch.equal(ops.matmul_grouped_q(torch.from_numpy(a), q, s,
                                            col_groups=cg), got)


def test_k5_wrapper_checks_its_operands():
    a = torch.zeros(1, 128, 128)
    q = torch.zeros(2, 128, 128)
    with pytest.raises(ValueError, match="col_groups"):
        pim_matmul_grouped_q(a, q, torch.ones(2, 1, 128))      # G != 1 * 1
    with pytest.raises(ValueError, match="shapes"):
        pim_matmul_grouped_q(a, q[:1], torch.ones(1, 128, 1))
    with pytest.raises(TypeError, match="float32"):
        pim_matmul_grouped_q(a, q[:1].double(), torch.ones(1, 1, 128))


@pytest.mark.parametrize("case", [(2, 2, 128, 128, 128),
                                  (3, 1, 128, 256, 128)], ids=str)
def test_k5_straight_through_gradients(case):
    g, cg, m, k, n = case
    a, w, _, _ = _k5_operands(case, "int8", 50 + sum(case))
    gout = np.random.default_rng(51).standard_normal((g, m, n)).astype(
        np.float32)
    at = torch.from_numpy(a).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    q, s = quant.quantize_ste(wt, "int8", 1)
    out = pim_matmul_grouped_q(at, q, s, col_groups=cg)
    da, dw = torch.autograd.grad(out, (at, wt), torch.from_numpy(gout))
    # dA is K1's VJP at the dequantized point, bit for bit
    deq = (q * s).detach().requires_grad_(False)
    a2 = torch.from_numpy(a).requires_grad_(True)
    (da_k1,) = torch.autograd.grad(
        pim_matmul_grouped(a2, deq, col_groups=cg), a2,
        torch.from_numpy(gout))
    assert torch.equal(da, da_k1)
    # the composed weight gradient is Aᵀg (the STE divides K5's scale out)
    a_rep = torch.from_numpy(a).repeat_interleave(cg, 0)
    np.testing.assert_allclose(
        dw.numpy(), (a_rep.transpose(1, 2) @ torch.from_numpy(gout)).numpy(),
        **MM_TOL)

    def f_q(a_, w_):
        q_, s_ = ref_quant.quantize_ste(w_, "int8", 1)
        return jnp.sum(ref_kernels.pim_matmul_grouped_q(
            a_, q_, s_, col_groups=cg, interpret=True) * gout)

    rda, rdw = jax.grad(f_q, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(w))
    np.testing.assert_allclose(da.numpy(), np.asarray(rda), **MM_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), **MM_TOL)


def test_k5_vjp_launches_only_the_cotangents_asked(monkeypatch):
    pm = importlib.import_module("repro_torch.kernels.pim_mac")
    calls = []
    real = pm._matmul_grouped
    monkeypatch.setattr(pm, "_matmul_grouped",
                        lambda *a: calls.append(a[5]) or real(*a))
    a, w, q, s = _k5_operands((2, 2, 128, 128, 128), "fp16", 3)
    at = torch.from_numpy(a).requires_grad_(True)
    out = pim_matmul_grouped_q(at, q, s, col_groups=2)
    torch.autograd.grad(out.sum(), at)
    assert calls == [1]                     # dA only, one grouped launch
    qt = q.clone().requires_grad_(True)
    out = pim_matmul_grouped_q(torch.from_numpy(a), qt, s, col_groups=2)
    (dq,) = torch.autograd.grad(out.sum(), qt)
    assert calls == [1, 2]                  # dq only, shared A
    assert dq.shape == q.shape


# ---------------------------------------------------------------------------
# planning: the quantized schedules equal the reference's node for node
# ---------------------------------------------------------------------------

PLAN_CASES = [(kind, batch, wd, ad) for kind, batch in
              (("serve", 4), ("serve", 256), ("train", 4), ("train", 32))
              for wd, ad in [(g, "fp32") for g in QDTYPES]
              + [("fp32", "fp8_e4m3"), ("int8", "fp8_e4m3")]]


def _assert_schedules_equal(port, ref_sched):
    rp, pp = ref_sched.placement, port.placement
    assert sorted(pp.node_placements) == sorted(rp.node_placements)
    for idx, want in rp.node_placements.items():
        assert dataclasses.astuple(pp.node_placements[idx]) == \
            dataclasses.astuple(want)
        assert [dataclasses.astuple(b) for b in pp.iter_blocks(idx, 0)] == [
            dataclasses.astuple(b) for b in rp.iter_blocks(idx, 0)]
    assert (pp.n_subarrays, pp.n_tiles, pp.curve) == (
        rp.n_subarrays, rp.n_tiles, rp.curve)
    assert pp.signature() == rp.signature()
    assert port.act_bits == ref_sched.act_bits
    assert dataclasses.astuple(port.report) == dataclasses.astuple(
        ref_sched.report)
    for s_port, s_ref in zip(port.stages, ref_sched.stages, strict=True):
        got = dataclasses.replace(s_port, name=s_ref.name)
        assert dataclasses.astuple(got) == dataclasses.astuple(s_ref)
    got, want = port.reconcile(), ref_sched.reconcile()
    assert got["counts_match"] and got["latency_ge_ideal"]
    assert got == want


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_map_lenet_quantized_schedule_equals_reference(case):
    kind, batch, wd, ad = case
    _assert_schedules_equal(
        mapper.map_lenet(kind, batch=batch, weight_dtype=wd, act_dtype=ad),
        ref_mapper.map_lenet(kind, batch=batch, weight_dtype=wd,
                             act_dtype=ad))


def test_reference_planning_numbers_at_lenet_shapes():
    """Serve at 256 and train at 64: the quantized placements free area
    and spend it on replicas (the reference's numbers)."""
    serve = {g: mapper.map_lenet("serve", batch=256, weight_dtype=g)
             for g in ("fp32",) + QDTYPES}
    assert serve["fp32"].placement.n_subarrays == 5
    for g in QDTYPES:
        pl = serve[g].placement
        assert pl.n_subarrays == 1
        assert all((p.row_blocks, p.col_blocks) == (1, 1)
                   for p in pl.node_placements.values())
    lat = {g: s.report.latency_s for g, s in serve.items()}
    assert lat["int8"] == pytest.approx(0.04518, rel=1e-3)
    assert lat["fp16"] == pytest.approx(0.08606, rel=1e-3)
    assert lat["fp8_e4m3"] == pytest.approx(0.02847, rel=1e-3)
    assert lat["fp8_e5m2"] == pytest.approx(0.02624, rel=1e-3)
    reps = {}
    for g in ("fp32", "int8", "fp16"):
        pl = mapper.map_lenet("train", batch=64, weight_dtype=g).placement
        reps[g] = sum(p.replicas for p in pl.node_placements.values())
        assert max(p.row_blocks for p in pl.node_placements.values()) == 41
    assert reps == {"fp32": 14, "int8": 29, "fp16": 25}


@pytest.mark.parametrize("provision", ["fp32", "quantized"])
def test_ideal_provision_equals_reference(provision):
    port = mapper.map_lenet("serve", batch=16, weight_dtype="int8",
                            ideal_provision=provision)
    want = ref_mapper.map_lenet("serve", batch=16, weight_dtype="int8",
                                ideal_provision=provision)
    assert port.ideal_provision == provision
    _assert_schedules_equal(port, want)
    with pytest.raises(ValueError, match="ideal_provision"):
        mapper.map_lenet("serve", weight_dtype="int8",
                         ideal_provision="dense")


def _adamw_steps():
    ref_opt = ref_make_optimizer("adamw", lr=2e-3)
    opt = make_optimizer("adamw", lr=2e-3)

    def ref_step(params, opt_state, batch):
        imgs, labels = batch
        loss, grads = jax.value_and_grad(ref_lenet.lenet_loss)(
            params, jnp.asarray(imgs), jnp.asarray(labels))
        params, opt_state = ref_opt.update(grads, opt_state, params)
        return params, opt_state, loss

    def step(params, opt_state, batch):
        imgs, labels = batch
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, imgs, labels)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return ref_opt, ref_step, opt, step


def test_adamw_step_int8_schedule_equals_reference():
    ref_opt, ref_step, opt, step = _adamw_steps()
    ref_params = ref_lenet.init_lenet(jax.random.PRNGKey(0), REF_CONFIG)
    batch = RefDigits(batch_size=32, seed=0).batch(0)
    want = ref_mapper.build_schedule(
        ref_step, ref_params, ref_opt.init(ref_params), batch,
        weight_dtype="int8")
    params = lenet.init_lenet(0, LENET5, device="meta")
    meta = tuple(torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                             device="meta") for x in batch)
    port = mapper.build_schedule(step, params, opt.init(params), meta,
                                 weight_dtype="int8")
    assert len(port.graph.nodes) == len(want.graph.nodes) == 180
    _assert_schedules_equal(port, want)


def test_weight_bits_gauge_and_error_histogram():
    obs.metrics().reset()
    sched = mapper.map_lenet("serve", batch=8, weight_dtype="int8")
    assert obs.metrics().gauge("pim.weight_bits").value == 8.0
    params = lenet.init_lenet(0, device="cpu")
    imgs, _ = make_digits(8, seed=2)
    mapper.compile_schedule(sched, device="cpu")(params,
                                                 torch.from_numpy(imgs))
    h = obs.metrics().histogram("pim.quant_layer_rel_error")
    assert h.count == 0              # the compiled replay does not sync
    mapper.ScheduleExecutor(sched, device="cpu").run(
        params, torch.from_numpy(imgs))
    assert h.count == 5              # one per placed block
    assert h.max <= quant.layer_error_budget("int8") * (1 + 1e-6)
    sched = mapper.map_lenet("serve", batch=8, act_dtype="fp16")
    assert obs.metrics().gauge("pim.act_bits").value == 16.0


# ---------------------------------------------------------------------------
# execution: compiled == executor, logits against the reference's
# fake-quant model, the stationary operand quantized
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_params():
    params = jax.tree.map(np.asarray, ref_lenet.init_lenet(
        jax.random.PRNGKey(0), REF_CONFIG))
    rng = np.random.default_rng(15)
    for leaves in params.values():
        leaves["b"] = rng.standard_normal(leaves["b"].shape).astype(
            np.float32)
    return params


_FAKE_QUANT: dict = {}


def _ref_fake_quant_params(ref_params, dtype):
    """Each weight through the reference's ``fake_quant``, per output
    column of its (k, n) view (the placed block's), outside ``jit``. The
    five views go side by side into one zero-padded matrix, one call:
    a column's scale is its own absmax, which zero rows never move."""
    if dtype not in _FAKE_QUANT:
        views = {k: v["w"].reshape(-1, v["w"].shape[-1])
                 for k, v in ref_params.items()}
        rows = max(w.shape[0] for w in views.values())
        wide = np.concatenate([np.pad(w, ((0, rows - w.shape[0]), (0, 0)))
                               for w in views.values()], axis=1)
        fq = np.asarray(ref_quant.fake_quant(jnp.asarray(wide), dtype))
        out, col = {}, 0
        for layer, w in views.items():
            k, n = w.shape
            out[layer] = {
                "w": fq[:k, col:col + n].reshape(ref_params[layer]["w"].shape),
                "b": ref_params[layer]["b"]}
            col += n
        _FAKE_QUANT[dtype] = out
    return _FAKE_QUANT[dtype]


@pytest.mark.parametrize("dtype", QDTYPES)
def test_compiled_serve_matches_fake_quant_reference_and_executor(
        ref_params, dtype):
    batch = 16
    params = lenet_params_from_reference(ref_params, device="cpu")
    imgs, _ = make_digits(batch, seed=5)
    x = torch.from_numpy(imgs)
    prog = mapper.compile_lenet("serve", batch=batch, weight_dtype=dtype,
                                device="cpu")
    pl = prog.schedule.placement
    # the fake-quant oracle quantizes whole columns: one row block each
    assert all(p.row_blocks == 1 for p in pl.node_placements.values())
    got = prog(params, x)
    assert (prog.matmul_launches, prog.kernel_launches) == (5, 10)
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    assert torch.equal(got, ex.run(params, x))
    assert ex.matmul_launches == prog.placed_blocks == 5
    want = jax.jit(ref_lenet.lenet_apply)(
        _ref_fake_quant_params(ref_params, dtype), imgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and it is not the fp32 model: the grid shows in the logits
    fp32 = jax.jit(ref_lenet.lenet_apply)(ref_params, imgs)
    assert float(np.abs(got.numpy() - np.asarray(fp32)).max()) > 1e-4


def test_program_cache_separates_weight_grids():
    mapper.clear_program_cache()
    progs = {g: mapper.compile_lenet("serve", batch=4, weight_dtype=g,
                                     device="cpu")
             for g in ("fp32",) + QDTYPES}
    assert len({id(p) for p in progs.values()}) == 5
    assert mapper.compile_lenet("serve", batch=4, weight_dtype="int8",
                                device="cpu") is progs["int8"]
    assert mapper.program_cache_stats()["misses"] == 5


def _two_matmul(x, w1, w2):
    return (x @ w1) @ w2


@pytest.mark.parametrize("dtype", QDTYPES)
def test_row_and_column_blocks_carry_their_own_scales(dtype):
    """A product whose stationary weight spans several row and column
    blocks: the compiled program equals the executor, and both equal
    ``x @ w`` over a weight fake-quantized per (row block, column) with
    the quantizer — not per whole column."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((8, 2100)).astype(np.float32)
    w1 = _weights(22, 2100, 300)
    w2 = rng.standard_normal((300, 40)).astype(np.float32)
    args = tuple(torch.from_numpy(a) for a in (x, w1, w2))
    sched = mapper.build_schedule(_two_matmul, *(a.to("meta") for a in args),
                                  weight_dtype=dtype)
    np1 = sched.placement.node_placements[sched.graph.matmul_like()[0].idx]
    assert np1.row_blocks >= 3 and np1.col_blocks >= 2
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    got = prog(*args)
    assert torch.equal(got, mapper.run_schedule(sched, *args, device="cpu"))
    h = sched.hierarchy.subarray.weight_rows
    # the port's fake_quant (bit-equal to the reference's, tests above)
    fq1 = np.concatenate([quant.fake_quant(torch.from_numpy(w1[r:r + h]),
                                           dtype).numpy()
                          for r in range(0, 2100, h)])
    fq2 = quant.fake_quant(torch.from_numpy(w2), dtype).numpy()
    want = (x.astype(np.float64) @ fq1) @ fq2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("dtype", QDTYPES)
def test_train_step_quantizes_the_stationary_operand(monkeypatch, dtype):
    """Every placed product of the AdamW step quantizes exactly the
    operand the reference places as the node's stationary weight (shape
    ``node.weight_shape``) over its block grid, and the compiled step
    equals the executor bit for bit."""
    _, _, opt, step = _adamw_steps()
    params = lenet.init_lenet(0, device="cpu")
    opt_state = opt.init(params)
    batch = tuple(torch.from_numpy(v) for v in
                  DigitsDataset(batch_size=8, seed=0).batch(1))
    sched = mapper.build_schedule(
        step, *mapper.abstract_like((params, opt_state, batch)),
        weight_dtype=dtype)
    stationary, quantized = [], []
    real_mm, real_q = lowering.blocked_matmul, quant.quantize_ste
    monkeypatch.setattr(lowering, "blocked_matmul", lambda ctx, idx, a2, b2: (
        stationary.append((idx, tuple(b2.shape)))
        or real_mm(ctx, idx, a2, b2)))
    monkeypatch.setattr(lowering.quant, "quantize_ste", lambda w, d, ax: (
        quantized.append((tuple(w.shape), d, ax)) or real_q(w, d, ax)))
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    got = prog(params, opt_state, batch)
    nodes = {nd.idx: nd for nd in sched.graph.nodes}
    pls = sched.placement.node_placements
    assert len(stationary) == prog.matmul_launches == 11
    assert all(shape == nodes[idx].weight_shape for idx, shape in stationary)
    assert [(g, d, ax) for (g, _, _), d, ax in quantized] == [
        (pls[idx].row_blocks * pls[idx].col_blocks, dtype, 1)
        for idx, _ in stationary]
    cgs = sorted(pls[idx].col_blocks for idx, _ in stationary)
    assert cgs[-1] == (4 if dtype == "fp16" else 2)     # shared-A K5
    want = mapper.ScheduleExecutor(sched, device="cpu").run(
        params, opt_state, batch)
    assert all(torch.equal(g, w) for g, w in zip(
        pytree.tree_leaves(got), pytree.tree_leaves(want), strict=True))


@pytest.mark.parametrize("dtype", QDTYPES)
def test_train_step_matches_plain_step_over_fake_quant_operands(dtype):
    """One compiled AdamW step (loss, gradients through the optimizer's
    state, updated parameters) within 1e-4 of the same step run with
    native ops only, each placed product's stationary operand
    fake-quantized per (row block, column) by ``run_fake_quant_plain`` —
    an oracle that shares no kernel, padding, stacking or fusion with the
    lowering — and, as a control, off the fp32 plain step."""
    _, _, opt, step = _adamw_steps()
    params = lenet.init_lenet(0, device="cpu")
    opt_state = opt.init(params)
    batch = tuple(torch.from_numpy(v) for v in
                  DigitsDataset(batch_size=8, seed=0).batch(1))
    state = (params, opt_state, batch)
    sched = mapper.build_schedule(step, *mapper.abstract_like(state),
                                  weight_dtype=dtype)
    got = mapper.compile_schedule(sched, use_cache=False,
                                  device="cpu")(*state)
    want = run_fake_quant_plain(sched, *state)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want),
                    strict=True):
        torch.testing.assert_close(g, w, **TOL)
    fp32 = step(*state)
    assert any(not torch.allclose(g, w, **TOL) for g, w in zip(
        pytree.tree_leaves(got), pytree.tree_leaves(fp32), strict=True))


def test_grad_through_compiled_int8_loss_is_plain_grad_at_fake_quant(
        ref_params):
    """Autograd through a compiled int8 ``lenet_loss``: K5's VJP and the
    straight-through quantizer give the plain gradient taken at the
    fake-quant weights."""
    params = lenet_params_from_reference(ref_params, device="cpu")
    imgs, labels = make_digits(16, seed=9)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    prog = mapper.compile_schedule(mapper.build_schedule(
        lenet.lenet_loss, *mapper.abstract_like((params, x, y)),
        weight_dtype="int8"), use_cache=False, device="cpu")
    tree = {k: {j: v.clone().requires_grad_(True) for j, v in leaves.items()}
            for k, leaves in params.items()}
    flat = pytree.tree_leaves(tree)
    grads = torch.autograd.grad(prog(tree, x, y), flat)
    fq = lenet_params_from_reference(
        _ref_fake_quant_params(ref_params, "int8"), device="cpu")
    want = pytree.tree_leaves(torch.func.grad(lenet.lenet_loss)(fq, x, y))
    for g, w in zip(grads, want, strict=True):
        torch.testing.assert_close(g, w, **TOL)
    ref_want = jax.grad(ref_lenet.lenet_loss)(
        _ref_fake_quant_params(ref_params, "int8"), imgs, labels)
    got = pytree.tree_unflatten(list(grads), pytree.tree_structure(tree))
    for layer, leaves in got.items():
        for name, g in leaves.items():
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(ref_want[layer][name]),
                                       **TOL)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _trainer(tmp_path, backend, **kw):
    _, _, opt, step = _adamw_steps()

    def init_state():
        p = lenet.init_lenet(0, device="cpu")
        return p, opt.init(p)

    tc = TrainerConfig(total_steps=5, ckpt_every=50, ckpt_dir=str(tmp_path),
                       async_ckpt=False)
    return Trainer(tc, train_step=step, init_state=init_state,
                   batch_fn=DigitsDataset(batch_size=32, seed=0).batch,
                   backend=backend, device="cpu", **kw)


def test_trainer_int8_losses_track_fp32(tmp_path):
    losses = {}
    for name, kw in (("fp32", {}), ("int8", {"weight_dtype": "int8",
                                             "act_dtype": "fp8_e4m3"})):
        tr = _trainer(tmp_path / name, "pim", **kw)
        losses[name] = tr.run()["losses"]
        assert tr.pim_program.matmul_launches == 11
    assert tr.pim_program.schedule.act_bits == 8
    assert tr.pim_program.schedule.hierarchy.subarray.weight_dtype == "int8"
    rel = max(abs(a - b) / max(abs(a), 1e-6)
              for a, b in zip(losses["fp32"], losses["int8"]))
    assert rel < 0.02        # the reference's contract
    assert losses["int8"] != losses["fp32"]


@pytest.mark.parametrize("option", [dict(weight_dtype="int8"),
                                    dict(act_dtype="fp8_e4m3")], ids=str)
def test_weight_dtype_rejected_off_pim_backend(tmp_path, option):
    with pytest.raises(ValueError, match="backend='pim'"):
        _trainer(tmp_path, "jit", **option)
