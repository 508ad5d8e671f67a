"""K3 over a wave of members read where they lie (``mac_wave``), on the CPU.

K3 takes a whole eltwise wave in one launch: each member's ``acc + a*b``
over its shape, a tensor operand read through its strides (0 on a
broadcast dim), a number as a float32 immediate, each output written in
the layout its node was traced with. On the CPU a wave runs its plain
version (``ref.pim_mac_wave_ref``, called once per launch); the card's
table (``_plan``, ``filled_table``) is built here too and run by
``_emulate``, a numpy reading of the packed bytes as the kernel reads
them: the same addresses, the same two roundings. Inputs are made with
numpy from a seed.

* The wave against the reference's Pallas ``pim_mac_grouped`` in
  interpret mode, on materialized operands: within 1 ulp of max(|a*b|,
  |out|), the reference's CPU FMA contraction (ROADMAP queue 3); NaN as
  NaN, infinities exact.
* The wave, its plain version and its emulated table against the
  formulation before waves read operands in place (operands broadcast
  and made contiguous, the constants as ``ones_like``, ``-one`` and
  ``zeros_like``, then ``pim_mac_ref``): bit for bit, NaN as NaN; ``0 +
  (-0)`` reads ``+0``.
* The mapper's eltwise path makes no fill, copy, negation, concatenation
  or host-to-device copy around a launch (``TorchDispatchMode`` over one
  compiled AdamW step); its steps equal the per-block executor and the
  pre-change path bit for bit, at 79 / 129 K3 launches a step and 5 per
  LeNet call; ``pim_grad``'s gradients equal the pre-change path's bit
  for bit, with one backward launch per cotangent asked; every wave the
  LeNet paths plan fits the member cap, and a larger one raises.
"""

import collections
import ctypes
import importlib
import struct
import tempfile
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import mapper
from repro_torch.core import estimator
from repro_torch.data import DigitsDataset, make_digits
from repro_torch.kernels import ref
from repro_torch.kernels.pim_mac import (MAC_MAX_MEMBERS, MacMember,
                                         mac_wave, pack_rows, pim_mac,
                                         pim_mac_grouped, wave_rows)
from repro_torch.mapper import lowering
from repro_torch.models import lenet
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer, TrainerConfig

# the reference module, and the port's kernel module (each package's
# ``kernels.pim_mac`` attribute is the function of that name)
pallas = importlib.import_module("repro.kernels.pim_mac")
pm = importlib.import_module("repro_torch.kernels.pim_mac")


# ---------------------------------------------------------------------------
# the kernel's table, read in numpy
# ---------------------------------------------------------------------------

# csrc struct Member: out, ptr[3] (0: an immediate), n, stride[3][4],
# size[4], magic[3], imm[3], first_block, shift[3], flags
_ROW = pm._MEMBER


def _floats(address: int, count: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_float * count).from_address(
        address))


def _emulate(table, rows: int) -> None:
    """K3's launch over ``rows`` packed members, in numpy: each member's
    blocks from the first-block prefix; a flat member's pointers read at
    element i (dense) or 0 (one value), a strided member's at the dot of
    i's coordinates over the collapsed shape with their strides, the
    coordinates divided as the kernel divides them (multiply-shift below
    2^31 elements); the output written densely, ``acc + a*b`` in float32
    (two roundings)."""
    next_block = 0
    for i in range(rows):
        row = _ROW.unpack_from(table, i * pm._MEMBER_BYTES)
        out, ptrs, n = row[0], row[1:4], row[4]
        strides = np.array(row[5:17]).reshape(3, 4)
        size, magic, imm = row[17:21], row[21:24], row[24:27]
        first_block, shift, flags = row[27], row[28:31], row[31]
        assert first_block == next_block and n >= 1
        next_block += -(-n // pm.MAC_BLOCK)
        idx = np.arange(n, dtype=np.int64)
        strided = flags & pm._FLAG_STRIDED
        if strided and flags & pm._FLAG_VEC:    # four elements at a time
            assert size[3] % 4 == 0 and not flags & pm._FLAG_WIDE
            for r in range(3):
                assert not ptrs[r] or strides[r][3] == 0 or (
                    strides[r][3] == 1 and ptrs[r] % 16 == 0
                    and not (strides[r][:3] % 4).any())
        coords, rem = [], idx.copy()
        for d in (2, 1, 0):            # c3, c2, c1 as the kernel takes them
            s = size[d + 1]
            if strided and not flags & pm._FLAG_WIDE:
                q = (((rem * magic[d]) >> 32) + rem) >> shift[d]
                assert np.array_equal(q, rem // s)
            else:
                q = rem // s
            coords.append(rem - q * s)
            rem = q
        coords = [rem] + coords[::-1]
        vals = []
        for r in range(3):
            if not ptrs[r]:
                vals.append(np.float32(imm[r]))
                continue
            if strided:
                at = sum(c * s for c, s in zip(coords, strides[r]))
            elif flags & (1 << r):      # dense
                assert not flags & pm._FLAG_VEC or ptrs[r] % 16 == 0
                at = idx
            else:                       # one value
                assert not strides[r].any()
                at = np.zeros(n, np.int64)
            vals.append(_floats(ptrs[r], int(at.max()) + 1)[at])
        a, b, acc = vals
        with np.errstate(all="ignore"):
            res = (np.float32(acc) + np.float32(a) * np.float32(b)).astype(
                np.float32)
        _floats(out, n)[:] = np.broadcast_to(res, (n,))


def _on_the_table(members) -> list[torch.Tensor]:
    """The wave as the card computes it, on CPU memory: ``mac_wave``'s
    members planned (``_plan``), the table filled for one allocation
    (``filled_table``, as each launch fills it), then ``_emulate``."""
    members = pm._normalized(members, "test")
    plan = pm._plan(members)
    buf = torch.full((plan.total,), float("nan"))
    values = [r.values for r in plan.rows]
    _emulate(pm.filled_table(plan, values, buf.data_ptr()), plan.live)
    return [buf.as_strided(r.shape, r.out_stride, r.offset)
            for r in plan.rows]


def _bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bit for bit, NaN as NaN."""
    x, y = x.detach().numpy(), y.detach().numpy()
    if x.shape != y.shape:
        return False
    nan = np.isnan(x)
    return bool((nan == np.isnan(y)).all()) and np.array_equal(
        x[~nan].view(np.uint32), y[~nan].view(np.uint32))


def _within_one_ulp(got: np.ndarray, want: np.ndarray, a, b) -> None:
    """|got - want| <= 1 ulp of max(|a*b|, |want|) where finite; NaN as
    NaN and infinities exact elsewhere."""
    got, want, a, b = (np.atleast_1d(x) for x in (got, want, a, b))
    with np.errstate(all="ignore"):
        prod = np.abs(a.astype(np.float64) * b.astype(np.float64))
    finite = np.isfinite(want) & np.isfinite(prod)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    rest = ~finite & ~np.isnan(want)
    assert np.array_equal(got[rest], want[rest])
    scale = np.maximum(prod, np.abs(want.astype(np.float64)))[finite]
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    err = np.abs(got[finite].astype(np.float64)
                 - want[finite].astype(np.float64))
    assert np.all(err <= ulp), float((err / ulp).max())


# ---------------------------------------------------------------------------
# member forms
# ---------------------------------------------------------------------------


def _wave(case: str, seed: int) -> list[MacMember]:
    """A wave of members of one form, from a seed."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    if case == "dense_ragged":
        return [MacMember(s, t(*s), t(*s), t(*s))
                for s in ((5, 7), (64,), (2, 3, 4), (1031,))]
    if case == "bias_nchw":      # a [C] bias over NCHW, as NHWC and NCHW
        x = t(4, 6, 5, 5)
        nhwc = x.permute(0, 2, 3, 1)
        return [MacMember(tuple(nhwc.shape), nhwc, 1.0, t(6), nhwc.stride()),
                MacMember((4, 6, 5, 5), x, 1.0, t(6, 1, 1))]
    if case == "bias_nc":        # a [C] bias over [N, C]
        return [MacMember((8, 35), t(8, 35), 1.0, t(35))]
    if case == "zero_d":         # a 0-d tensor operand, and a 0-d output
        s = t()
        return [MacMember((3, 4), t(3, 4), s, 0.0),
                MacMember((), s, -1.0, 1)]
    if case == "scalars":        # AdamW's float64 constants
        x = t(257)
        return [MacMember((257,), x, 0.1, 0.0),
                MacMember((257,), x, 1e-8, 0.0),
                MacMember((257,), x, 1 - 0.999, 0.0),
                MacMember((257,), x, 1.0, 1e-8),
                MacMember((257,), x, 1 - 0.9, t(257))]
    if case == "rsub":           # rsub(y, 1) = 1 + y*(-1)
        return [MacMember((7, 3), t(7, 3), -1.0, 1)]
    if case == "neg_zero":       # products that are -0: 0 + (-0) = +0;
        a = torch.tensor([-0.0, 0.0, -1.0, 1e-30, -3.0, 2.0])
        b = torch.tensor([1.0, -1.0, 0.0, -1e-30, 0.0, -0.0])
        # and an immediate -0: -0 + (-0) = -0; rsub(y, -0) = -0 - y
        return [MacMember((6,), a, b, 0.0), MacMember((6,), a, 1.0, -0.0),
                MacMember((6,), a, -1.0, -0.0)]
    if case == "nan_inf":
        inf, nan = float("inf"), float("nan")
        a = torch.tensor([nan, inf, -inf, 1.0, inf, 0.0, 2.0])
        b = torch.tensor([1.0, 0.0, 2.0, inf, 1.0, nan, 3.0])
        acc = torch.tensor([0.0, 1.0, inf, -inf, -inf, 1.0, nan])
        return [MacMember((7,), a, b, acc), MacMember((7,), a, inf, 0.0)]
    if case == "strided":        # transposed and sliced operands
        a = t(7, 5).T
        return [MacMember((5, 7), a, t(5, 14)[:, ::2], t(5, 7)),
                MacMember((5, 7), a, 2.0, t(1, 7), (1, 5))]
    raise KeyError(case)


CASES = ("dense_ragged", "bias_nchw", "bias_nc", "zero_d", "scalars",
         "rsub", "neg_zero", "nan_inf", "strided")


def _full(x, shape) -> np.ndarray:
    """An operand materialized at the member's shape, in float32."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.float32(x)
    return np.ascontiguousarray(np.broadcast_to(x, shape)).astype(np.float32)


def _pre_change(member) -> torch.Tensor:
    """The formulation before waves read operands in place: each operand
    broadcast and laid out contiguously, then the plain MAC."""
    shape = member.shape

    def full(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32),
                                  shape).contiguous()

    return ref.pim_mac_ref(full(member.a), full(member.b),
                           full(member.acc))


@pytest.mark.parametrize("case", CASES)
def test_k3_wave_matches_pallas_to_one_ulp(case):
    members = _wave(case, CASES.index(case))
    got = mac_wave(members)
    triples = [tuple(_full(x, m.shape) for x in m[1:4]) for m in members]
    want = pallas.pim_mac_grouped(
        [tuple(jnp.asarray(x) for x in t) for t in triples], interpret=True)
    assert len(got) == len(members)
    for g, w, (a, b, _), m in zip(got, want, triples, members):
        assert tuple(g.shape) == tuple(m.shape)
        assert g.dtype == torch.float32
        # the reference's wave returns a 0-d member as one element
        _within_one_ulp(g.numpy(), np.asarray(w).reshape(m.shape), a, b)


@pytest.mark.parametrize("case", CASES)
def test_k3_wave_equals_pre_change_formulation_and_its_table(case):
    members = _wave(case, 100 + CASES.index(case))
    got = mac_wave(members)
    table = _on_the_table(members)
    for g, t_, m in zip(got, table, members):
        want = _pre_change(m)
        assert _bits_equal(g, want), m.shape
        assert _bits_equal(t_.contiguous(), want), m.shape
        if m.stride is not None:       # the card writes the asked layout
            assert t_.stride() == tuple(m.stride)


def test_a_mixed_wave_is_one_launch_and_equals_its_members(monkeypatch):
    calls = []
    real = ref.pim_mac_wave_ref
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        lambda ms: calls.append(len(ms)) or real(ms))
    members = [m for i, c in enumerate(CASES) for m in _wave(c, 200 + i)]
    got = mac_wave(members)
    assert calls == [len(members)]
    for g, t_, m in zip(got, _on_the_table(members), members):
        assert _bits_equal(g, mac_wave([m])[0])
        assert _bits_equal(t_.contiguous(), g)
    # the forms the table gives these members: flat (dense, one value,
    # immediates) and strided
    rows, _ = wave_rows(pm._normalized(members, "test"))
    kinds = collections.Counter(
        "strided" if r.flags & pm._FLAG_STRIDED else "flat" for r in rows)
    assert kinds["flat"] >= 10 and kinds["strided"] >= 4


def test_mul_of_negative_zero_reads_plus_zero():
    m, plus_neg_zero, rsub_neg_zero = _wave("neg_zero", 0)
    want = torch.mul(m.a, m.b)
    assert (want.view(torch.int32) == -(2 ** 31)).all()      # all -0
    for got in (mac_wave([m])[0], _on_the_table([m])[0]):
        assert (got.view(torch.int32) == 0).all()            # all +0
    # an immediate -0 keeps its sign, and never shares a plan with +0
    a = m.a
    for member, want in ((plus_neg_zero, a + -0.0), (rsub_neg_zero,
                                                     -0.0 - a)):
        assert bool(torch.signbit(want[:2]).any())       # a -0 to keep
        assert _bits_equal(mac_wave([member])[0], want)
        assert _bits_equal(_on_the_table([member])[0], want)
    assert pm._signature([plus_neg_zero])[0] != pm._signature(
        [plus_neg_zero._replace(acc=0.0)])[0]


def test_immediates_are_rounded_to_float32_once():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32) * np.float32(1e3))
    for s in (0.1, 1e-8, 1 - 0.999, 1 - 0.9, 3.3e38):
        (got,) = mac_wave([MacMember((4096,), x, s, 0.0)])
        want = torch.zeros(()) + x * torch.tensor(s, dtype=torch.float32)
        assert _bits_equal(got, want)
        assert _bits_equal(_on_the_table([MacMember((4096,), x, s, 0.0)])[0],
                           want)


def test_an_operand_past_four_dims_is_copied_and_counted():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 3, 8, 5, 12, 7)).astype(
        np.float32))[::2, :, ::2, :, ::2, :]             # 2,3,4,5,6,7
    y = torch.from_numpy(rng.standard_normal((7, 6, 5, 4, 3, 2)).astype(
        np.float32)).permute(5, 4, 3, 2, 1, 0)
    m = MacMember(tuple(x.shape), x, y, 0.5)
    before = pim_mac.materialized
    (got,) = _on_the_table([m])
    assert pim_mac.materialized > before
    assert _bits_equal(got.contiguous(), _pre_change(m))


@pytest.mark.parametrize("n", [MAC_MAX_MEMBERS + 1, 600])
def test_a_wave_above_the_member_cap_is_one_launch(n, monkeypatch):
    """A wave of more members than one table passed by value holds (the
    card then reads the same table from device memory) is one launch, bit
    for bit the plain version, its packed table and the pre-change
    formulation, every member form among its members."""
    forms = [m for case in CASES for m in _wave(case, n)]
    members = [forms[i % len(forms)] for i in range(n)]
    calls = []
    real = ref.pim_mac_wave_ref
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        lambda ms: calls.append(len(ms)) or real(ms))
    got = mac_wave(members)
    assert calls == [n]
    table = _on_the_table(members)
    for m, g, t in zip(members, got, table, strict=True):
        want = _pre_change(m)
        assert _bits_equal(g.contiguous(), want)
        assert _bits_equal(t.contiguous(), want)
    rows, _ = wave_rows(pm._normalized(members, "test"))
    assert len(pack_rows([r for r in rows if r.n])) == sum(
        1 for r in rows if r.n) * pm._MEMBER_BYTES > (
        MAC_MAX_MEMBERS * pm._MEMBER_BYTES)


def test_table_layout_is_the_c_struct():
    assert pm._MEMBER.size == pm._MEMBER_BYTES == 184
    # first_block sits after out, ptr[3], n, stride[3][4] (8 bytes each),
    # size[4], magic[3], imm[3] (4 bytes each); flags is the last byte
    assert pm._MAC_LAYOUT == (184, MAC_MAX_MEMBERS, pm.MAC_BLOCK,
                              8 * (1 + 3 + 1 + 12) + 4 * (4 + 3 + 3))
    assert pm._FLAGS_AT == 183
    # the largest table in a launch's 32,764 bytes of parameters
    assert 8 + 184 * MAC_MAX_MEMBERS <= 32764 < 8 + 184 * (
        MAC_MAX_MEMBERS + 1)


def test_multiply_shift_division_is_exact():
    rng = np.random.default_rng(7)
    ds = np.concatenate([np.arange(1, 300), rng.integers(1, 2 ** 31, 300),
                         [2 ** k for k in range(32)],
                         [2 ** k - 1 for k in range(1, 32)],
                         [2 ** k + 1 for k in range(1, 31)]])
    xs = np.concatenate([np.arange(0, 5000), rng.integers(0, 2 ** 31, 5000),
                         [2 ** 31 - 1, 2 ** 31 - 2]]).astype(object)
    for d in ds.tolist():
        magic, shift = pm.divisor(d)
        assert 0 < magic < 2 ** 32 and shift < 32
        q = [(((int(x) * magic) >> 32) + int(x)) >> shift for x in xs]
        assert q == [int(x) // d for x in xs], d


def test_public_wrappers_keep_the_reference_contract():
    with pytest.raises(ValueError, match="differ"):
        pim_mac_grouped([(torch.zeros(3), torch.zeros(3), torch.zeros(2))])
    with pytest.raises(TypeError, match="float32"):
        mac_wave([MacMember((3,), torch.zeros(3, dtype=torch.float64),
                            1.0, 0.0)])
    with pytest.raises(ValueError, match="broadcast"):
        mac_wave([MacMember((3,), torch.zeros(4), 1.0, 0.0)])
    with pytest.raises(ValueError, match="tensor operand"):
        mac_wave([MacMember((3,), 1.0, 2.0, 0.0)])
    out = pim_mac_grouped([(torch.ones(0), torch.ones(0), torch.ones(0)),
                           (torch.ones(2), torch.ones(2), torch.ones(2))])
    assert out[0].shape == (0,) and out[1].tolist() == [2.0, 2.0]


# ---------------------------------------------------------------------------
# the VJP over a wave
# ---------------------------------------------------------------------------


class _OldMac(torch.autograd.Function):
    """K3's autograd Function before waves (its plain version): da and db
    are MACs into a ``zeros_like`` accumulator, dacc = g."""

    @staticmethod
    def forward(ctx, a, b, acc):
        ctx.save_for_backward(a, b)
        return ref.pim_mac_ref(a, b, acc)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        need_a, need_b, need_acc = ctx.needs_input_grad
        zero = torch.zeros_like(g) if need_a or need_b else None
        da = ref.pim_mac_ref(g, b, zero) if need_a else None
        db = ref.pim_mac_ref(g, a, zero) if need_b else None
        return da, db, g if need_acc else None


def _old_wave(members, name="pim_mac") -> list[torch.Tensor]:
    """The eltwise path before waves read operands in place: each operand
    through ``torch.as_tensor``, ``broadcast_to`` and ``contiguous`` (the
    constants so becoming ones, minus ones and zeros), the triples
    flattened, concatenated, run as one MAC and split."""
    triples = []
    for shape, a, b, acc, *_ in members:
        dev = next(x.device for x in (a, b, acc)
                   if isinstance(x, torch.Tensor))
        triples.append(tuple(torch.broadcast_to(torch.as_tensor(
            x, dtype=torch.float32, device=dev), shape).contiguous()
            for x in (a, b, acc)))
    if len(triples) == 1:
        return [_OldMac.apply(*triples[0])]
    flat = _OldMac.apply(*(torch.cat([t[i].reshape(-1) for t in triples])
                           for i in range(3)))
    return [part.reshape(t[0].shape) for part, t in zip(
        torch.split(flat, [t[0].numel() for t in triples]), triples)]


@pytest.mark.parametrize("case", ("dense_ragged", "bias_nchw", "bias_nc",
                                  "zero_d", "scalars", "strided"))
def test_k3_wave_vjp_equals_pre_change_bit_for_bit(case, monkeypatch):
    calls = []
    real = ref.pim_mac_wave_ref
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        lambda ms: calls.append(1) or real(ms))
    rng = np.random.default_rng(300 + CASES.index(case))

    def leaves():
        out = []
        for m in _wave(case, 400 + CASES.index(case)):
            out.append(MacMember(m.shape, *(
                x.clone().requires_grad_(True)
                if isinstance(x, torch.Tensor) else x for x in m[1:4]),
                m.stride))
        return out

    cots = [torch.from_numpy(rng.standard_normal(m.shape).astype(
        np.float32)) for m in _wave(case, 400 + CASES.index(case))]
    grads = []
    for wave in (mac_wave, _old_wave):
        members = leaves()
        ins = [x for m in members for x in m[1:4]
               if isinstance(x, torch.Tensor)]
        calls.clear()
        outs = wave(members)
        forward = len(calls)
        torch.autograd.backward(outs, cots)
        grads.append([x.grad for x in ins])
        if wave is mac_wave:
            # one launch forward; one for every da and one for every db
            # asked over the wave, whatever its members
            asked = [any(isinstance(m[r], torch.Tensor) for m in members)
                     for r in (1, 2)]
            assert (forward, len(calls) - forward) == (1, sum(asked))
    for g, w in zip(*grads, strict=True):
        assert _bits_equal(g, w)


# ---------------------------------------------------------------------------
# the mapper's eltwise path
# ---------------------------------------------------------------------------


def _adamw_trainer(weight_dtype="fp32", batch=8) -> Trainer:
    opt = make_optimizer("adamw", lr=2e-3)

    def init_state():
        p = lenet.init_lenet(0, device="cpu")
        return p, opt.init(p)

    def train_step(params, opt_state, batch_):
        imgs, labels = batch_
        grads, loss = torch.func.grad_and_value(lenet.lenet_loss)(
            params, imgs, labels)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    tc = TrainerConfig(total_steps=1, ckpt_every=50,
                       ckpt_dir=tempfile.mkdtemp(), async_ckpt=False)
    return Trainer(tc, train_step=train_step, init_state=init_state,
                   batch_fn=DigitsDataset(batch_size=batch, seed=0).batch,
                   backend="pim", device="cpu", weight_dtype=weight_dtype)


@pytest.fixture(scope="module")
def trainer():
    return _adamw_trainer()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched while ``state["eltwise"]`` is set
    and ``state["plain"]`` is not."""

    def __init__(self, state):
        super().__init__()
        self.state, self.seen = state, collections.Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if self.state["eltwise"] and not self.state["plain"]:
            self.seen[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _count_eltwise_ops(monkeypatch, prog, args, wave_fn) -> tuple:
    """The ops the eltwise path dispatches outside K3's plain version (the
    kernel's stand-in here) over one call of ``prog``, with the lowering's
    wave entry ``wave_fn``; beside it, each wave's table planned and
    filled as on the card (``_signature``, ``_plan``, ``filled_table``:
    all the card's host path does but allocate the outputs and launch).
    Returns (ops, the waves' member counts)."""
    state = {"eltwise": 0, "plain": 0}
    sizes = []

    def inside(fn, key):
        def call(*a, **k):
            state[key] += 1
            try:
                return fn(*a, **k)
            finally:
                state[key] -= 1
        return call

    def wave(members, *rest):
        sizes.append(len(members))
        if wave_fn is mac_wave:     # the card's host path, but the launch
            pm._signature(members)
            plan = pm._plan(pm._normalized(members, "test"))
            pm.filled_table(plan, [m[1:4] for m in members], 0)
        return wave_fn(members, *rest)

    monkeypatch.setattr(lowering, "_eltwise_member",
                        inside(lowering._eltwise_member, "eltwise"))
    monkeypatch.setattr(lowering, "mac_wave", inside(wave, "eltwise"))
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        inside(ref.pim_mac_wave_ref, "plain"))
    monkeypatch.setattr(ref, "pim_mac_ref", inside(ref.pim_mac_ref, "plain"))
    with _Ops(state) as mode:
        prog(*args)
    monkeypatch.undo()
    return mode.seen, sizes


def test_eltwise_path_makes_no_fill_copy_or_cat(trainer, monkeypatch):
    prog = trainer.pim_program
    args = (trainer.params, trainer.opt_state, trainer._batch(0))
    seen, sizes = _count_eltwise_ops(monkeypatch, prog, args, mac_wave)
    assert not seen, dict(seen)
    assert (len(sizes), sum(sizes)) == (79, 129)
    # the control: the pre-change path's fills, copies and concatenations
    # are seen by the same count
    old, _ = _count_eltwise_ops(monkeypatch, prog, args, _old_wave)
    assert old["clone"] > 0 and old["cat"] > 0 and old["expand"] > 0


def test_train_step_equals_executor_and_pre_change_path(trainer,
                                                        monkeypatch):
    prog = trainer.pim_program
    args = (trainer.params, trainer.opt_state, trainer._batch(1))
    calls = []
    real = ref.pim_mac_wave_ref
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        lambda ms: calls.append(len(ms)) or real(ms))
    got = prog(*args)
    assert (len(calls), sum(calls)) == (79, 129)
    assert (prog.eltwise_launches, prog.eltwise_calls) == (79, 129)
    calls.clear()
    ex = mapper.ScheduleExecutor(prog.schedule, device="cpu")
    want = ex.run(*args)
    assert (len(calls), ex.eltwise_launches) == (129, 129)
    monkeypatch.setattr(lowering, "mac_wave", _old_wave)
    before = prog(*args)
    for g, w, b in zip(_leaves(got), _leaves(want), _leaves(before),
                       strict=True):
        assert _bits_equal(g, w) and _bits_equal(g, b)


def test_each_wave_of_the_step_runs_on_the_table(trainer, monkeypatch):
    """Every wave of one compiled AdamW step through the card's table and
    ``_emulate``: equal to the plain version bit for bit; each output in
    its node's traced layout (so ``_conform`` copies none on the card);
    no operand copied."""
    prog = trainer.pim_program
    args = (trainer.params, trainer.opt_state, trainer._batch(2))
    waves = []
    real = pm._mac

    def spy(members, *rest):
        outs = real(members, *rest)
        waves.append((pm._normalized(members, "test"), outs))
        return outs

    monkeypatch.setattr(pm, "_mac", spy)
    before = pim_mac.materialized
    prog(*args)
    assert len(waves) == 79
    flat = strided = vec_strided = 0
    for members, outs in waves:
        rows, _ = wave_rows(members)
        for r, m in zip(rows, members):
            assert r.out_stride == tuple(m.stride)
            flat += not r.flags & pm._FLAG_STRIDED
            strided += bool(r.flags & pm._FLAG_STRIDED)
        vec_strided += sum(bool(r.flags & pm._FLAG_STRIDED
                                and r.flags & pm._FLAG_VEC)
                           for r in pm._plan(members).rows)
        for t_, o in zip(_on_the_table(members), outs):
            assert _bits_equal(t_.contiguous(), o.contiguous())
    assert pim_mac.materialized == before
    # the step's 129 members: the bias adds over NHWC views and the
    # permuted conv-weight updates read strided, the rest flat
    assert flat + strided == 129 and flat > strided > 0
    # the conv bias adds read four elements at a time
    assert vec_strided >= 2


def test_lenet_paths_plan_waves_under_the_member_cap():
    plans = [mapper.compile_lenet("serve", batch=8, device="cpu"),
             mapper.compile_lenet("serve", batch=8, weight_dtype="int8",
                                  device="cpu"),
             _adamw_trainer().pim_program,
             _adamw_trainer("int8").pim_program]
    for prog in plans:
        sizes = [1 + len(st.peers) for st in prog.ctx.steps
                 if st.kind == "placed" and st.node.kind == "eltwise"]
        assert sizes and max(sizes) <= MAC_MAX_MEMBERS
    assert [len([s for s in p.ctx.steps if s.kind == "placed"
                 and s.node.kind == "eltwise"]) for p in plans] == [5, 5,
                                                                    79, 79]


def test_lenet_call_is_five_launches():
    prog = mapper.compile_lenet("serve", batch=8, device="cpu")
    imgs, _ = make_digits(8, seed=1)
    params = lenet.init_lenet(0, device="cpu")
    for layer in params.values():
        layer["b"] = torch.linspace(-1, 1, layer["b"].numel())
    before = pim_mac.launches
    calls = []
    real = ref.pim_mac_wave_ref
    try:
        ref.pim_mac_wave_ref = lambda ms: calls.append(len(ms)) or real(ms)
        out = prog(params, torch.from_numpy(imgs))
    finally:
        ref.pim_mac_wave_ref = real
    assert calls == [1] * 5 and pim_mac.launches == before
    assert torch.equal(out, mapper.ScheduleExecutor(
        prog.schedule, device="cpu").run(params, torch.from_numpy(imgs)))


def _mac_nodes(loss) -> list:
    """The K3 wave nodes of ``loss``'s autograd graph."""
    seen, stack, out = set(), [loss.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == "_MacWaveBackward":
            out.append(fn)
        stack.extend(f for f, _ in fn.next_functions)
    return out


def test_pim_grad_equals_pre_change_path(monkeypatch):
    """Autograd through a compiled ``lenet_loss`` with seeded non-zero
    biases: the gradients equal the pre-change path's bit for bit (each
    bias's through ``sum_to_size`` of its add's cotangent), and the
    backward makes one K3 launch per cotangent asked."""
    b = 16
    params = lenet.init_lenet(0, device="cpu")
    rng = np.random.default_rng(5)
    for layer in params.values():
        layer["b"] = torch.from_numpy(rng.standard_normal(
            layer["b"].shape).astype(np.float32))
    imgs, labels = make_digits(b, seed=2)
    args = (torch.from_numpy(imgs), torch.from_numpy(labels))
    sched = mapper.build_schedule(lenet.lenet_loss,
                                  mapper.abstract_like(params),
                                  *mapper.abstract_like(args))
    prog = mapper.compile_schedule(sched, use_cache=False, device="cpu")
    calls = []
    real = ref.pim_mac_wave_ref
    monkeypatch.setattr(ref, "pim_mac_wave_ref",
                        lambda ms: calls.append(len(ms)) or real(ms))
    grads = []
    for wave in (mac_wave, _old_wave):
        monkeypatch.setattr(lowering, "mac_wave", wave)
        leaves = [v.clone().requires_grad_(True)
                  for layer in params.values() for v in layer.values()]
        it = iter(leaves)
        tree = {k: {j: next(it) for j in layer}
                for k, layer in params.items()}
        calls.clear()
        loss = prog(tree, *args)
        forward = len(calls)
        nodes = _mac_nodes(loss)
        grads.append(torch.autograd.grad(loss, leaves))
        if wave is mac_wave:
            asked = sum(n.asked[0] + n.asked[1] for n in nodes)
            # 5 bias adds, each asking for its activation's cotangent (a
            # launch) and its bias's (g summed to the bias's shape)
            assert forward == 5 and len(nodes) == 5
            assert len(calls) - forward == asked == 5
            assert all(n.asked == (True, False, True) for n in nodes)
    for g, w in zip(*grads, strict=True):
        assert _bits_equal(g, w)


def test_eltwise_member_rules():
    """The lowering's rules on traced nodes: add is ``y + x*1``, sub ``x +
    y*(-1)``, mul ``0 + x*y``, rsub(y, s) ``s + y*(-1)``; numbers stay
    numbers and the traced layout rides along; each equals its aten op
    (mul but for the sign of a zero product)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5, 5)).astype(
        np.float32)).permute(0, 2, 3, 1)
    y = torch.from_numpy(rng.standard_normal(6).astype(np.float32))

    def fn(x, y):
        return x + y, x - 0.1, x * 1e-8, 1 - x, y * y

    gm = make_fx(fn)(x, y)
    env = dict(zip([n for n in gm.graph.nodes if n.op == "placeholder"],
                   (x, y)))
    seen = collections.Counter()
    for fx in gm.graph.nodes:
        if fx.op != "call_function":
            continue
        args = torch.fx.node.map_arg(fx.args, env.__getitem__)
        env[fx] = fx.target(*args)
        op = estimator.ELTWISE_OPS.get(fx.target)
        if op is None:
            continue
        member = lowering._eltwise_member(
            fx, types.SimpleNamespace(op=op), args)
        assert member.stride == env[fx].stride()
        assert not any(isinstance(v, torch.Tensor) and v.dim() == 0
                       for v in member[1:4])
        (got,) = mac_wave([member])
        assert _bits_equal(got, env[fx]) or (
            op == "mul" and torch.equal(got, env[fx]))
        seen[str(fx.target)] += 1
    assert seen == {"aten.add.Tensor": 1, "aten.sub.Tensor": 1,
                    "aten.mul.Tensor": 2, "aten.rsub.Scalar": 1}
