"""Recurrent sequence blocks: mLSTM + sLSTM (xLSTM) and Mamba2 (SSD) — the
port of ``repro.models.ssm``.

Each block has three forms:
  * ``*_seq``   — a whole [B, S, D] sequence, one token after another
                  (the reference's ``lax.scan`` over time, a Python loop
                  here): the oracle of the chunked forms;
  * ``*_seq_chunked`` (mLSTM, Mamba2) — the chunkwise-parallel forms that
                  the reference's prefill runs: O(S / L) sequential steps,
                  the work inside a chunk as dense products; ``slstm_seq``
                  is the sLSTM's only sequence form;
  * ``*_step``  — one decode step with an O(1) recurrent state.

Gating uses the xLSTM stabilized exponential-gate formulation (log-space
stabilizer m), so long sequences do not overflow in bf16. The states and
gates are float32, the projections in the model dtype, as in the
reference.

A block's parameters are a mapping from the reference's leaf names
(``"norm/scale"``, ``"w_q"``, …) to tensors: a slice of the stacked tree,
or the block's module (``RecurrentBlock``, made by ``mlstm_block``,
``slstm_block``, ``mamba2_block``: ``m["w_q"]`` reads the parameter of
that name). The step forms are spelled as the
reference's jaxpr has them, so the mapper traces its priced ops in its
order: ``jax.nn.gelu``'s eight ops written out (``gelu``: six priced),
``softplus``, ``silu``, ``sigmoid``, ``exp``, ``maximum`` and
``jnp.repeat`` as unpriced ops, and each ``einsum`` as the ``bmm`` whose
operands, batch dims and output layout are its ``dot_general``'s.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def mlstm_shapes(d: int, n_heads: int) -> dict[str, tuple[int, ...]]:
    """The reference's ``init_mlstm`` leaves and their shapes."""
    return {"f_bias": (n_heads,), "norm/scale": (d,), "w_f": (d, n_heads),
            "w_i": (d, n_heads), "w_k": (d, d), "w_o": (d, d),
            "w_proj_down": (2 * d, d), "w_proj_up": (d, 2 * d),
            "w_q": (d, d), "w_v": (d, d)}


def slstm_shapes(d: int, n_heads: int) -> dict[str, tuple[int, ...]]:
    """The reference's ``init_slstm`` leaves and their shapes."""
    return {"f_bias": (n_heads,), "norm/scale": (d,), "r_z": (d, d),
            "w_f": (d, n_heads), "w_i": (d, n_heads), "w_o": (d, d),
            "w_proj_down": (2 * d, d), "w_proj_up": (d, 2 * d),
            "w_z": (d, d)}


def mamba2_shapes(d: int, ssm_state: int, headdim: int,
                  conv_width: int) -> dict[str, tuple[int, ...]]:
    """The reference's ``init_mamba2`` leaves and their shapes."""
    d_in = 2 * d
    nh = d_in // headdim
    return {"a_log": (nh,), "conv": (conv_width, 1, d_in), "d_skip": (nh,),
            "dt_bias": (nh,), "norm/scale": (d,), "w_b": (d_in, ssm_state),
            "w_c": (d_in, ssm_state), "w_dt": (d, nh),
            "w_in": (d, 2 * d_in), "w_out": (d_in, d)}


# leaf -> how the reference's init fills it: a float is a constant, a
# tuple ("dense", scale) a normal draw × scale (None: fan_in^-0.5); the
# norm's scale is ones (``layers.RMSNorm``)
_FILLS = {"f_bias": 3.0, "dt_bias": 0.0, "a_log": 0.0, "d_skip": 1.0,
          "w_i": ("dense", 0.02), "w_f": ("dense", 0.02),
          "r_z": ("dense", 0.02), "w_b": ("dense", 0.02),
          "w_c": ("dense", 0.02), "w_dt": ("dense", 0.02)}


class RecurrentBlock(nn.Module):
    """One recurrent block's parameters, named as the reference's leaves
    (``shapes``): the norm's scale under ``norm``, the rest as direct
    parameters. ``m["w_q"]`` / ``m["norm/scale"]`` read them by leaf
    name, so the block functions take the module or a tree slice alike."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], eps: float,
                 dtype, device):
        super().__init__()
        self.leaves = tuple(shapes)
        self.norm = layers.RMSNorm(shapes["norm/scale"][0], eps, dtype,
                                   device)
        for name, shape in shapes.items():
            if name != "norm/scale":
                setattr(self, name, layers.empty_param(shape, dtype, device))

    def init(self, generator: torch.Generator) -> None:
        """The reference's distributions (its numbers differ: another
        generator): projections normal × fan_in^-0.5, the gates' and
        state projections × 0.02, ``f_bias`` 3, ``dt_bias`` and ``a_log``
        0, ``d_skip`` 1."""
        for name in self.leaves:
            if name == "norm/scale":
                continue
            fill = _FILLS.get(name, ("dense", None))
            w = getattr(self, name)
            if isinstance(fill, tuple):
                layers.dense_init_(w, generator, scale=fill[1])
            else:
                with torch.no_grad():
                    w.fill_(fill)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.get_parameter(name.replace("/", "."))


def mlstm_block(d: int, n_heads: int, eps: float, dtype,
                device) -> RecurrentBlock:
    return RecurrentBlock(mlstm_shapes(d, n_heads), eps, dtype, device)


def slstm_block(d: int, n_heads: int, eps: float, dtype,
                device) -> RecurrentBlock:
    return RecurrentBlock(slstm_shapes(d, n_heads), eps, dtype, device)


def mamba2_block(d: int, ssm_state: int, headdim: int, conv_width: int,
                 eps: float, dtype, device) -> RecurrentBlock:
    return RecurrentBlock(mamba2_shapes(d, ssm_state, headdim, conv_width),
                          eps, dtype, device)


# ---------------------------------------------------------------------------
# shared spellings
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) as its jaxpr spells it: the
    cube (unpriced), then mul, add, mul, tanh, add, mul, mul — six ops
    the reference's graph prices, where ``F.gelu`` is one unpriced op."""
    c = math.sqrt(2 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x.pow(3)))))


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    """``-softplus(-f)``, log sigmoid(f): the reference's ``softplus`` is
    a call its graph does not price."""
    return -F.softplus(-f)


def _repeat(x: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.repeat(x, n, axis=-1)`` of x [B, H]: a broadcast and a
    reshape, unpriced."""
    b, h = x.shape
    return x[..., None].expand(b, h, n).reshape(b, h * n)


def _block_out(x: torch.Tensor, hidden: torch.Tensor, gate_in: torch.Tensor,
               p) -> torch.Tensor:
    """The xLSTM block's tail: the output gate ``sigmoid(gate_in @ w_o)``
    on ``hidden``, then ``x + gelu(hidden @ w_proj_up) @ w_proj_down``."""
    hidden = hidden * torch.sigmoid(gate_in @ p["w_o"])
    up = hidden @ p["w_proj_up"]
    return x + gelu(up) @ p["w_proj_down"]


# ---------------------------------------------------------------------------
# mLSTM (matrix memory) — xLSTM [arXiv:2405.04517]
# ---------------------------------------------------------------------------


def mlstm_state(batch: int, n_heads: int, dk: int, dv: int,
                device=None) -> dict[str, torch.Tensor]:
    """The reference's ``mlstm_state``, its keys in sorted order (the
    order a JAX scan takes them and a compiled step's cache keeps)."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, dk, dv), **f32),
            "m": torch.full((batch, n_heads), -1e30, **f32),
            "n": torch.zeros((batch, n_heads, dk), **f32)}


def _mlstm_cell(state: dict, q, k, v, i_pre, f_pre):
    """One stabilized mLSTM step. q/k/v: [B, H, dk|dv] f32; gates [B, H].
    The two einsums are the reference's ``dot_general``s over (b, h):
    ``n·q`` and ``Cᵀq`` with C's value axis the free one."""
    c_prev, n_prev, m_prev = state["C"], state["n"], state["m"]
    b, h, dk = q.shape
    dv = v.shape[-1]
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m_prev, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m_prev - m_new)
    c_new = (f_g[..., None, None] * c_prev
             + i_g[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = f_g[..., None] * n_prev + i_g[..., None] * k
    nq = torch.bmm(n_new.reshape(b * h, 1, dk),
                   q.reshape(b * h, dk, 1)).view(b, h)
    denom = torch.maximum(torch.abs(nq), torch.exp(-m_new))
    cq = torch.bmm(c_new.transpose(-1, -2).reshape(b * h, dv, dk),
                   q.reshape(b * h, dk, 1)).view(b, h, dv)
    return {"C": c_new, "m": m_new, "n": n_new}, cq / denom[..., None]


def _mlstm_gates_qkv(x: torch.Tensor, p, n_heads: int):
    b, s, d = x.shape
    dk = d // n_heads
    q = (x @ p["w_q"]).reshape(b, s, n_heads, dk) * (dk ** -0.5)
    k = (x @ p["w_k"]).reshape(b, s, n_heads, dk)
    v = (x @ p["w_v"]).reshape(b, s, n_heads, dk)
    i_pre = (x @ p["w_i"]).float()
    f_pre = (x @ p["w_f"]).float() + p["f_bias"].float()
    return q, k, v, i_pre, f_pre


def mlstm_seq(x: torch.Tensor, p, n_heads: int) -> torch.Tensor:
    """[B, S, D] -> [B, S, D], one token after another."""
    b, s, d = x.shape
    h = layers.rms_norm(x, p["norm/scale"])
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(h, p, n_heads)
    state = mlstm_state(b, n_heads, d // n_heads, d // n_heads, x.device)
    outs = []
    for t in range(s):
        state, out = _mlstm_cell(state, q[:, t].float(), k[:, t].float(),
                                 v[:, t].float(), i_pre[:, t], f_pre[:, t])
        outs.append(out)
    hidden = torch.stack(outs, 1).reshape(b, s, d).to(x.dtype)
    return _block_out(x, hidden, h, p)


def mlstm_step(x: torch.Tensor, p, state: dict,
               n_heads: int) -> tuple[torch.Tensor, dict]:
    """One decode step. x: [B, 1, D]."""
    b, _, d = x.shape
    h = layers.rms_norm(x, p["norm/scale"])
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(h, p, n_heads)
    state, out = _mlstm_cell(state, q[:, 0].float(), k[:, 0].float(),
                             v[:, 0].float(), i_pre[:, 0], f_pre[:, 0])
    hidden = out.reshape(b, 1, d).to(x.dtype)
    return _block_out(x, hidden, h, p), state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory) — xLSTM
# ---------------------------------------------------------------------------


def slstm_state(batch: int, d_model: int, n_heads: int,
                device=None) -> dict[str, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d_model), **f32),
            "h": torch.zeros((batch, d_model), **f32),
            "m": torch.full((batch, n_heads), -1e30, **f32),
            "n": torch.zeros((batch, d_model), **f32)}


def _slstm_cell(state: dict, z_pre, i_pre, f_pre, n_heads: int):
    b, d = z_pre.shape
    dh = d // n_heads
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = _repeat(torch.exp(i_pre - m_new), dh)
    f_g = _repeat(torch.exp(log_f + state["m"] - m_new), dh)
    z = torch.tanh(z_pre)
    c_new = f_g * state["c"] + i_g * z
    n_new = f_g * state["n"] + i_g
    h_new = c_new / n_new.clamp_min(1e-6)
    return {"c": c_new, "h": h_new, "m": m_new, "n": n_new}, h_new


def slstm_seq(x: torch.Tensor, p, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    xn = layers.rms_norm(x, p["norm/scale"])
    z_pre_all = xn @ p["w_z"]
    i_pre_all = (xn @ p["w_i"]).float()
    f_pre_all = (xn @ p["w_f"]).float() + p["f_bias"].float()
    state = slstm_state(b, d, n_heads, x.device)
    outs = []
    for t in range(s):
        # the recurrent connection from the previous hidden state
        z_rec = (state["h"].to(x.dtype) @ p["r_z"]).float()
        state, h = _slstm_cell(state, z_pre_all[:, t].float() + z_rec,
                               i_pre_all[:, t], f_pre_all[:, t], n_heads)
        outs.append(h)
    hidden = torch.stack(outs, 1).to(x.dtype)
    return _block_out(x, hidden, xn, p)


def slstm_step(x: torch.Tensor, p, state: dict,
               n_heads: int) -> tuple[torch.Tensor, dict]:
    xn = layers.rms_norm(x, p["norm/scale"])
    z_rec = (state["h"].to(x.dtype) @ p["r_z"]).float()
    z_pre = (xn[:, 0] @ p["w_z"]).float() + z_rec
    i_pre = (xn[:, 0] @ p["w_i"]).float()
    f_pre = (xn[:, 0] @ p["w_f"]).float() + p["f_bias"].float()
    state, h = _slstm_cell(state, z_pre, i_pre, f_pre, n_heads)
    hidden = h[:, None, :].to(x.dtype)
    return _block_out(x, hidden, xn, p), state


# ---------------------------------------------------------------------------
# Mamba2 (SSD) — zamba2's sequence mixer [arXiv:2411.15242]
# ---------------------------------------------------------------------------


def mamba2_state(batch: int, n_heads: int, headdim: int, ssm_state: int,
                 conv_width: int, d_in: int,
                 device=None) -> dict[str, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, conv_width - 1, d_in), **f32),
            "ssm": torch.zeros((batch, n_heads, headdim, ssm_state), **f32)}


def _mamba_proj(x: torch.Tensor, p) -> tuple[torch.Tensor, torch.Tensor]:
    xz = x @ p["w_in"]
    xi, z = xz.chunk(2, -1)                  # [B, S, d_in] each
    return xi, z


def _causal_conv_seq(xi: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xi: [B, S, C], conv_w: [W, 1, C]."""
    w, s = conv_w.shape[0], xi.shape[1]
    pad = F.pad(xi, (0, 0, w - 1, 0))
    out = torch.zeros_like(xi)
    for i in range(w):
        out = out + pad[:, i:i + s] * conv_w[i, 0]
    return F.silu(out)


def _mamba_inputs(x: torch.Tensor, p, headdim: int):
    """The norm, the in projection and the causal conv of a sequence,
    then B, C, dt, A and the heads of x, as the reference's two sequence
    forms compute them: (xn, z, xh [B, S, H, P], B [B, S, N], C, dt [B,
    S, H], a [H])."""
    b, s, _ = x.shape
    xn = layers.rms_norm(x, p["norm/scale"])
    xi, z = _mamba_proj(xn, p)
    xi = _causal_conv_seq(xi, p["conv"])
    d_in = xi.shape[-1]
    bmat = (xi @ p["w_b"]).float()
    cmat = (xi @ p["w_c"]).float()
    dt = F.softplus((xn @ p["w_dt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    xh = xi.reshape(b, s, d_in // headdim, headdim).float()
    return xn, z, xh, bmat, cmat, dt, a


def _mamba_out(x: torch.Tensor, y: torch.Tensor, xh: torch.Tensor,
               z: torch.Tensor, p) -> torch.Tensor:
    """The skip, the gate and the out projection: y [B, S, H, P] f32."""
    b, s = x.shape[:2]
    y = y + p["d_skip"].float()[:, None] * xh
    y = y.reshape(b, s, -1).to(x.dtype)
    y = y * F.silu(z)
    return x + y @ p["w_out"]


def mamba2_seq(x: torch.Tensor, p, *, ssm_state: int,
               headdim: int) -> torch.Tensor:
    """[B, S, D] -> [B, S, D], one token after another."""
    b, s, _ = x.shape
    _, z, xh, bmat, cmat, dt, a = _mamba_inputs(x, p, headdim)
    st = torch.zeros((b, xh.shape[2], headdim, ssm_state),
                     dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, bt, ct, dtt = xh[:, t], bmat[:, t], cmat[:, t], dt[:, t]
        decay = torch.exp(a * dtt)
        upd = (dtt[..., None] * xt)[..., None] * bt[:, None, None, :]
        st = decay[..., None, None] * st + upd
        ys.append((st @ ct[:, None, :, None])[..., 0])
    return _mamba_out(x, torch.stack(ys, 1), xh, z, p)


def mamba2_step(x: torch.Tensor, p, state: dict, *, ssm_state: int,
                headdim: int) -> tuple[torch.Tensor, dict]:
    """One decode step with the O(1) state. The causal conv runs over the
    rolling buffer: the reference's ``einsum("bwc,wc->bc")``, its
    ``dot_general`` over the channels as batch with the filter the left
    operand, [C, 1, W] @ [C, W, B], then its output [C, B] transposed."""
    b, _, d = x.shape
    xn = layers.rms_norm(x, p["norm/scale"])
    xi, z = _mamba_proj(xn, p)
    hist = torch.cat([state["conv"], xi[:, 0:1].float()], 1)   # [B, W, C]
    w = p["conv"][:, 0].float()                                  # [W, C]
    c = w.shape[1]
    conv_out = torch.bmm(w.t()[:, None, :], hist.permute(2, 1, 0)
                         ).view(c, b).t()
    xi1 = F.silu(conv_out)                                       # [B, d_in]
    new_conv = hist[:, 1:]
    nh = c // headdim
    bvec = xi1 @ p["w_b"].float()
    cvec = xi1 @ p["w_c"].float()
    dt = F.softplus((xn[:, 0] @ p["w_dt"]).float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    xh = xi1.reshape(b, nh, headdim)
    decay = torch.exp(a * dt)
    upd = (dt[..., None] * xh)[..., None] * bvec[:, None, None, :]
    ssm_new = decay[..., None, None] * state["ssm"] + upd
    # einsum("bhpn,bn->bhp"): batch b, (h, p) free, n contracted
    y = torch.bmm(ssm_new.reshape(b, nh * headdim, ssm_state),
                  cvec[:, :, None]).view(b, nh, headdim)
    y = y + p["d_skip"].float()[:, None] * xh
    y = y.reshape(b, 1, c).to(x.dtype)
    y = y * F.silu(z)
    return x + y @ p["w_out"], {"conv": new_conv, "ssm": ssm_new}


# ---------------------------------------------------------------------------
# chunked-parallel forms (prefill): O(S/L) sequential steps, the work
# inside a chunk as dense products
# ---------------------------------------------------------------------------


def _chunk(s: int, chunk: int) -> tuple[int, int]:
    """(chunk length, chunks) of a sequence of ``s``: the whole sequence
    below ``chunk``; raises ``ValueError`` where the chunk does not divide
    it (the reference asserts)."""
    length = min(chunk, s)
    if s % length:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {length}")
    return length, s // length


def mlstm_seq_chunked(x: torch.Tensor, p, n_heads: int,
                      chunk: int = 256) -> torch.Tensor:
    """Chunkwise stabilized mLSTM (the xLSTM appendix formulation).

    Within a chunk (length L), with F_t = cumsum(log f) and
    M_t = max(m_prev, cummax(i - F)):
      y_t      = e^{m_prev - M_t} q_t^T Chat_prev
                 + sum_{tau<=t} e^{i_tau - F_tau - M_t} (q_t.k_tau) v_tau
      Chat_new = e^{m_prev - M_L} Chat_prev + sum_tau e^{i-F-M_L} k v^T
    All exponents are <= 0: bf16-safe."""
    b, s, d = x.shape
    h_in = layers.rms_norm(x, p["norm/scale"])
    q, k, v, i_pre, f_pre = _mlstm_gates_qkv(h_in, p, n_heads)
    dk = d // n_heads
    l, nc = _chunk(s, chunk)

    def cshape(t):                   # [B, S, H, dk] -> [nc, B, H, L, dk]
        return t.float().reshape(b, nc, l, n_heads, -1).permute(1, 0, 3, 2,
                                                                4)

    qc, kc, vc = cshape(q), cshape(k), cshape(v)
    ic = i_pre.reshape(b, nc, l, n_heads).permute(1, 0, 3, 2)  # [nc,B,H,L]
    fc = f_pre.reshape(b, nc, l, n_heads).permute(1, 0, 3, 2)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    c_hat = torch.zeros((b, n_heads, dk, dk), dtype=torch.float32,
                        device=x.device)
    n_hat = torch.zeros((b, n_heads, dk), dtype=torch.float32,
                        device=x.device)
    m_prev = torch.full((b, n_heads), -1e30, dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(nc):
        qt, kt, vt, it, ft = qc[c], kc[c], vc[c], ic[c], fc[c]
        f_cum = torch.cumsum(_log_sigmoid(ft), -1)          # F_t
        g = it - f_cum                                       # i_tau - F_tau
        m_loc = torch.maximum(torch.cummax(g, -1).values, m_prev[..., None])
        # the intra-chunk decay D[t, tau] = exp(g_tau - M_t), causal
        dmat = torch.exp(g[:, :, None, :] - m_loc[:, :, :, None])
        dmat = torch.where(causal, dmat, 0.0)
        scores = (qt @ kt.transpose(-1, -2)) * dmat
        y_intra = scores @ vt
        inter_scale = torch.exp(m_prev[..., None] - m_loc)  # [B, H, L]
        y_inter = (qt @ c_hat) * inter_scale[..., None]
        y = y_intra + y_inter
        # the normalizer n_t = sum_tau D[t, tau] k_tau (the decay alone)
        n_t = dmat @ kt + n_hat[:, :, None, :] * inter_scale[..., None]
        denom = torch.abs((n_t * qt).sum(-1))
        denom = torch.maximum(denom, torch.exp(-(f_cum + m_loc)))
        ys.append(y / denom[..., None])
        # the state at the chunk's end
        m_end = m_loc[..., -1]
        w_state = torch.exp(g - m_end[..., None])           # [B, H, L]
        carry = torch.exp(m_prev - m_end)
        c_hat = (carry[..., None, None] * c_hat
                 + (kt * w_state[..., None]).transpose(-1, -2) @ vt)
        n_hat = carry[..., None] * n_hat + (kt * w_state[..., None]).sum(-2)
        m_prev = f_cum[..., -1] + m_end
    # [nc, B, H, L, dk] -> [B, S, D]
    hidden = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, d).to(
        x.dtype)
    return _block_out(x, hidden, h_in, p)


def mamba2_seq_chunked(x: torch.Tensor, p, *, ssm_state: int, headdim: int,
                       chunk: int = 128) -> torch.Tensor:
    """Chunked SSD (Mamba2's own block decomposition). Within a chunk:
    y = ((C Bᵀ) * decay mask) (dt x) + C decay S_prev; across chunks:
    S_new = e^{A_L} S_prev + sum_tau e^{A_L - A_tau} B (dt x)."""
    b, s, _ = x.shape
    _, z, xh, bmat, cmat, dt, a = _mamba_inputs(x, p, headdim)
    nh = xh.shape[2]
    l, nc = _chunk(s, chunk)
    xhc = xh.reshape(b, nc, l, nh, headdim).permute(1, 0, 3, 2, 4)
    bc = bmat.reshape(b, nc, l, -1).permute(1, 0, 2, 3)      # [nc,B,L,N]
    cc = cmat.reshape(b, nc, l, -1).permute(1, 0, 2, 3)
    dtc = dt.reshape(b, nc, l, nh).permute(1, 0, 3, 2)       # [nc,B,H,L]
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    st = torch.zeros((b, nh, headdim, ssm_state), dtype=torch.float32,
                     device=x.device)
    ys = []
    for c in range(nc):
        xt, bt, ct, dtt = xhc[c], bc[c], cc[c], dtc[c]
        a_cum = torch.cumsum(a[None, :, None] * dtt, -1)    # A_t (<= 0)
        # the decay mask exp(A_t - A_tau), causal
        dm = torch.exp(a_cum[:, :, :, None] - a_cum[:, :, None, :])
        dm = torch.where(causal, dm, 0.0)
        cb = ct @ bt.transpose(-1, -2)                       # [B, L, L]
        dx = dtt[..., None] * xt                             # [B, H, L, P]
        y_intra = (cb[:, None] * dm) @ dx
        y_inter = (ct[:, None] @ st.transpose(-1, -2)) * torch.exp(
            a_cum)[..., None]
        w_end = torch.exp(a_cum[..., -1:] - a_cum)           # [B, H, L]
        st = (torch.exp(a_cum[..., -1])[..., None, None] * st
              + (dx * w_end[..., None]).transpose(-1, -2) @ bt[:, None])
        ys.append(y_intra + y_inter)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, nh, headdim)
    return _mamba_out(x, y, xh, z, p)


# ---------------------------------------------------------------------------
# the differentiated forms: each block spelled on a ``lin.Tape`` (the train
# step's stack, ``transformer._RecurrentStack``): the reference's
# linearized forward, and through ``Tape.transpose`` its transpose
# ---------------------------------------------------------------------------


def last_index(n: int, device) -> torch.Tensor:
    """``-1`` normalized into an axis of ``n`` as the reference's indexing
    normalizes it (``x[..., -1]``; the ``add`` its graph prices), a 0-d
    int32 tensor on ``device``."""
    from repro_torch.models import attention
    return attention._wrapped(torch.full((), -1, dtype=torch.int32,
                                         device=device), n)


def _gelu_t(t, x):
    """``gelu`` on the tape: linearized, ``integer_pow``'s coefficient
    ``3·x²`` and ``tanh``'s ``1 - y`` besides its six products."""
    x3 = t.ipow(x, 3)
    inner = t.add(x, t.mul(0.044715, x3))
    th = t.tanh(t.mul(math.sqrt(2 / math.pi), inner))
    return t.mul(x, t.mul(0.5, t.add(1.0, th)))


def _block_out_t(t, x, hidden, gate_in, p, keep: bool):
    """``_block_out`` on the tape: ``sigmoid(gate_in @ w_o)`` gates
    ``hidden``, then ``x + gelu(hidden @ w_proj_up) @ w_proj_down``; with
    ``keep=False`` the last product and the sum are not evaluated (a
    recomputed block whose output nothing reads)."""
    o_gate = t.logistic(t.matmul(gate_in, p["w_o"]))
    hidden = t.mul(hidden, o_gate)
    act = _gelu_t(t, t.matmul(hidden, p["w_proj_up"]))
    with (t.dead() if not keep else contextlib.nullcontext()):
        return t.add(x, t.matmul(act, p["w_proj_down"]))


def _cummax_t(t, x, axis: int):
    """``lax.cummax`` along ``axis`` as its derivative computes it: JAX's
    ``associative_scan`` of ``max`` (strided slices, the pairwise maxima,
    their interleave as two pads and an ``add``)."""
    def combine(a, b):
        return t.maximum(a, b)

    def interleave(a, b):
        if a.shape[axis] == b.shape[axis]:
            return t.add(t.pad(a, axis, 0, 1, 1), t.pad(b, axis, 1, 0, 1))
        return t.add(t.pad(a, axis, 0, 0, 1), t.pad(b, axis, 1, 1, 1))

    def scan(e):
        n = e.shape[axis]
        if n < 2:
            return e
        odd = scan(combine(t.slice(e, axis, 0, n - 1, 2),
                           t.slice(e, axis, 1, n, 2)))
        if n % 2 == 0:
            even = combine(t.slice(odd, axis, 0, odd.shape[axis] - 1),
                           t.slice(e, axis, 2, n, 2))
        else:
            even = combine(odd, t.slice(e, axis, 2, n, 2))
        even = t.cat([t.slice(e, axis, 0, 1), even], axis)
        return interleave(even, odd)

    return scan(x)


def _repeat_t(t, x, n: int):
    """``jnp.repeat(x, n, axis=-1)`` of x [B, H] on the tape."""
    b, h = x.shape
    return t.reshape(t.expand(t.reshape(x, b, h, 1), b, h, n), b, h * n)


def _mlstm_chunk_t(t, causal, carry, xs, *, keep: bool, idx):
    """One chunk of ``mlstm_seq_chunked`` (the reference's checkpointed
    scan body) on the tape: carry (Ĉ, n̂, m) [B, H, dk, dk] / [B, H, dk] /
    [B, H], xs (q, k, v [B, H, L, dk], i, f [B, H, L]). ``idx``: the
    normalized ``-1`` of the two ``[..., -1]`` reads (hoisted by the
    caller, as the reference's linearization hoists them), None to make
    them here. ``keep=False``: what only the chunk's outputs read is not
    evaluated (its recompute in the transpose)."""
    c_hat, n_hat, m_prev = carry
    qt, kt, vt, it, ft = xs
    b, h, l, dk = qt.shape
    dead = (lambda: t.dead()) if not keep else contextlib.nullcontext
    bh = (([3], [2]), ([0, 1], [0, 1]))
    f_cum = t.cumsum(t.log_sigmoid(ft), -1)                  # F_t
    g = t.sub(it, f_cum)                                     # i - F
    m_loc = t.maximum(_cummax_t(t, g, 2), t.reshape(m_prev, b, h, 1))
    dmat = t.exp(t.sub(t.reshape(g, b, h, 1, l), t.reshape(m_loc, b, h, l,
                                                           1)))
    dmat = t.where(causal, dmat, 0.0)
    scores = t.mul(t.dot(qt, kt, (([3], [3]), ([0, 1], [0, 1]))), dmat)
    y_intra = t.dot(scores, vt, bh)
    inter = t.exp(t.sub(t.reshape(m_prev, b, h, 1), m_loc))   # [B, H, L]
    y_inter = t.mul(t.dot(qt, c_hat, bh), t.reshape(inter, b, h, l, 1))
    y = t.add(y_intra, y_inter)
    n_t = t.add(t.dot(dmat, kt, bh), t.mul(t.reshape(n_hat, b, h, 1, dk),
                                           t.reshape(inter, b, h, l, 1)))
    denom = t.abs(t.dot(n_t, qt, (([3], [3]), ([0, 1, 2], [0, 1, 2]))))
    m_t = t.add(f_cum, m_loc)
    denom = t.maximum(denom, t.exp(t.neg(m_t)))
    with dead():
        y = t.div(y, t.reshape(denom, b, h, l, 1))
    # the state at the chunk's end
    m_end = t.at(m_loc, 2, idx[0] if idx else last_index(l, qt.device))
    w_state = t.exp(t.sub(g, t.reshape(m_end, b, h, 1)))
    decay = t.exp(t.sub(m_prev, m_end))
    with dead():
        c_old = t.mul(t.reshape(decay, b, h, 1, 1), c_hat)
    vw = t.dot(vt, w_state, (([], []), ([0, 1, 2], [0, 1, 2])))
    with dead():
        c_new = t.add(c_old, t.dot(kt, vw, (([2], [2]), ([0, 1], [0, 1]))))
    decay = t.exp(t.sub(m_prev, m_end))
    with dead():
        n_new = t.add(t.mul(t.reshape(decay, b, h, 1), n_hat),
                      t.dot(kt, w_state, (([2], [2]), ([0, 1], [0, 1]))))
        at = idx[1] if idx else last_index(l, qt.device)
        m_new = t.add(t.at(f_cum, 2, at), m_end)
    return [c_new, n_new, m_new], [y]


def mlstm_block_t(t, x, p, n_heads: int, eps: float, *, keep: bool = True,
                  idx=None, chunk: int = 256):
    """``mlstm_seq_chunked`` on the tape (the train step's block): the
    chunks a checkpointed loop (``Tape.checkpoint_loop``, the ``"scan"``
    region ``"chunks"``). Where the tape linearizes, the chunk body's two
    ``-1`` indices are made once before the loop (the reference's
    linearization hoists them), or come hoisted further out in ``idx``
    (``chunk_indices``)."""
    b, s, d = x.shape
    dk = d // n_heads
    f32 = torch.float32
    h_in = t.rms_norm(x, p["norm/scale"], eps)
    q = t.mul(t.reshape(t.matmul(h_in, p["w_q"]), b, s, n_heads, dk),
              dk ** -0.5)
    k = t.reshape(t.matmul(h_in, p["w_k"]), b, s, n_heads, dk)
    v = t.reshape(t.matmul(h_in, p["w_v"]), b, s, n_heads, dk)
    i_pre = t.astype(t.matmul(h_in, p["w_i"]), f32)
    f_pre = t.add(t.astype(t.matmul(h_in, p["w_f"]), f32),
                  t.astype(p["f_bias"], f32))
    l, nc = _chunk(s, chunk)

    def cshape(u):               # [B, S, H, dk] -> [nc, B, H, L, dk]
        return t.permute(t.reshape(t.astype(u, f32), b, nc, l, n_heads, dk),
                         1, 0, 3, 2, 4)

    def gshape(u):               # [B, S, H] -> [nc, B, H, L]
        return t.permute(t.reshape(u, b, nc, l, n_heads), 1, 0, 3, 2)

    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    carry = [torch.zeros((b, n_heads, dk, dk), dtype=f32, device=x.device),
             torch.zeros((b, n_heads, dk), dtype=f32, device=x.device),
             torch.full((b, n_heads), -1e30, dtype=f32, device=x.device)]

    if t.lin and idx is None:    # hoisted out of the chunk loop
        idx = [last_index(l, x.device), last_index(l, x.device)]

    def body(tc, consts, c, xs, keep=True):
        return _mlstm_chunk_t(tc, causal, c, xs, keep=keep,
                              idx=idx if (t.lin and keep) else None)

    _, (ys,) = t.checkpoint_loop(
        body, carry, [cshape(q), cshape(k), cshape(v), gshape(i_pre),
                      gshape(f_pre)], [], "chunks")
    hidden = t.astype(t.reshape(t.permute(ys, 1, 0, 3, 2, 4), b, s, d),
                      x.dtype)
    return _block_out_t(t, x, hidden, h_in, p, keep)


def chunk_indices(cfg, s: int, device) -> list:
    """The normalized ``-1`` indices the chunk bodies of ``cfg``'s blocks
    read, made once before the stack as the reference's linearization
    hoists them out of its loops: the mLSTM's two, the Mamba2's one."""
    if cfg.block_pattern == "xlstm":
        l, _ = _chunk(s, 256)
        return [last_index(l, device), last_index(l, device)]
    l, _ = _chunk(s, 128)
    return [last_index(l, device)]


def _slstm_cell_t(t, consts, carry, xs, n_heads: int, dtype):
    """One token of ``slstm_seq`` on the tape (the reference's scan body):
    the recurrent product from the previous hidden state, then the cell.
    carry (c, h, m, n), xs (z, i, f) of the token."""
    (r_z,) = consts
    c, h_prev, m, n = carry
    zt, it, ft = xs
    b, d = zt.shape
    dh = d // n_heads
    f32 = torch.float32
    z_rec = t.astype(t.matmul(t.astype(h_prev, dtype), r_z), f32)
    z_pre = t.add(t.astype(zt, f32), z_rec)
    log_f = t.log_sigmoid(ft)
    m_new = t.maximum(t.add(log_f, m), it)
    i_g = _repeat_t(t, t.exp(t.sub(it, m_new)), dh)
    f_g = _repeat_t(t, t.exp(t.sub(t.add(log_f, m), m_new)), dh)
    z = t.tanh(z_pre)
    c_new = t.add(t.mul(f_g, c), t.mul(i_g, z))
    n_new = t.add(t.mul(f_g, n), i_g)
    h_new = t.div(c_new, t.maximum(n_new, 1e-6))
    return [c_new, h_new, m_new, n_new], [h_new]


def slstm_block_t(t, x, p, n_heads: int, eps: float, *,
                  keep: bool = True):
    """``slstm_seq`` on the tape: the tokens a loop (``Tape.loop``, the
    ``"scan"`` region ``"tokens"``) whose body is linearized where the
    tape is, its transpose the tokens' in reverse."""
    b, s, d = x.shape
    f32 = torch.float32
    xn = t.rms_norm(x, p["norm/scale"], eps)
    z_all = t.matmul(xn, p["w_z"])
    i_all = t.astype(t.matmul(xn, p["w_i"]), f32)
    f_all = t.add(t.astype(t.matmul(xn, p["w_f"]), f32),
                  t.astype(p["f_bias"], f32))
    st = slstm_state(b, d, n_heads, x.device)
    carry = [st["c"], st["h"], st["m"], st["n"]]
    _, (hs,) = t.loop(
        lambda tc, consts, c, xs: _slstm_cell_t(tc, consts, c, xs, n_heads,
                                                x.dtype),
        carry, [t.permute(z_all, 1, 0, 2), t.permute(i_all, 1, 0, 2),
                t.permute(f_all, 1, 0, 2)], [p["r_z"]], "tokens")
    hidden = t.astype(t.permute(hs, 1, 0, 2), x.dtype)
    return _block_out_t(t, x, hidden, xn, p, keep)


def _mamba_chunk_t(t, consts, carry, xs, causal, *, keep: bool, idx):
    """One chunk of ``mamba2_seq_chunked`` (the reference's checkpointed
    scan body) on the tape: consts (A [H],), carry (S [B, H, P, N],), xs
    (x [B, H, L, P], B, C [B, L, N], dt [B, H, L])."""
    (a,) = consts
    (st,) = carry
    xt, bt, ct, dtt = xs
    b, h, l, pdim = xt.shape
    dead = (lambda: t.dead()) if not keep else contextlib.nullcontext
    a_cum = t.cumsum(t.mul(t.reshape(a, 1, h, 1), dtt), -1)  # A_t (<= 0)
    dm = t.exp(t.sub(t.reshape(a_cum, b, h, l, 1), t.reshape(a_cum, b, h, 1,
                                                             l)))
    dm = t.where(causal, dm, 0.0)
    cb = t.dot(ct, bt, (([2], [2]), ([0], [0])))              # [B, L, L]
    scores = t.mul(t.reshape(cb, b, 1, l, l), dm)
    dx = t.mul(t.reshape(dtt, b, h, l, 1), xt)                # [B, H, L, P]
    with dead():
        y_intra = t.dot(scores, dx, (([3], [2]), ([0, 1], [0, 1])))
    y_st = t.permute(t.dot(st, ct, (([3], [2]), ([0], [0]))), 0, 1, 3, 2)
    with dead():
        y_inter = t.mul(y_st, t.reshape(t.exp(a_cum), b, h, l, 1))
    w_end = t.exp(t.sub(t.slice(a_cum, 2, l - 1, l), a_cum))  # [B, H, L]
    e_end = t.exp(t.at(a_cum, 2, idx[0] if idx else last_index(l, xt.device)))
    with dead():
        decayed = t.mul(t.reshape(e_end, b, h, 1, 1), st)
    dxw = t.dot(dx, w_end, (([], []), ([0, 1, 2], [0, 1, 2])))
    with dead():
        st_new = t.add(decayed, t.dot(dxw, bt, (([2], [1]), ([0], [0]))))
        y = t.add(y_intra, y_inter)
    return [st_new], [y]


def mamba2_block_t(t, x, p, *, ssm_state: int, headdim: int, eps: float,
                   keep: bool = True, idx=None, chunk: int = 128):
    """``mamba2_seq_chunked`` on the tape: the in projection, the causal
    conv (a sum of shifted products), B, C, dt, then the chunks a
    checkpointed loop (the ``"scan"`` region ``"chunks"``), the skip, the
    ``silu(z)`` gate and the out projection."""
    b, s, d = x.shape
    f32 = torch.float32
    xn = t.rms_norm(x, p["norm/scale"], eps)
    xz = t.matmul(xn, p["w_in"])
    d_in = xz.shape[-1] // 2
    xi, z = t.slice(xz, 2, 0, d_in), t.slice(xz, 2, d_in, 2 * d_in)
    conv = p["conv"]
    w = conv.shape[0]
    pad = t.pad(xi, 1, w - 1, 0)
    out = torch.zeros_like(xi)
    for i in range(w):
        out = t.add(out, t.mul(t.slice(pad, 1, i, i + s),
                               t.reshape(t.slice(conv, 0, i, i + 1), 1, 1,
                                         d_in)))
    xi = t.silu(out)
    nh = d_in // headdim
    bmat = t.astype(t.matmul(xi, p["w_b"]), f32)
    cmat = t.astype(t.matmul(xi, p["w_c"]), f32)
    dt = t.softplus(t.add(t.astype(t.matmul(xn, p["w_dt"]), f32),
                          t.astype(p["dt_bias"], f32)))
    a = t.neg(t.exp(t.astype(p["a_log"], f32)))
    xh = t.astype(t.reshape(xi, b, s, nh, headdim), f32)
    l, nc = _chunk(s, chunk)
    causal = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    st0 = torch.zeros((b, nh, headdim, ssm_state), dtype=f32,
                      device=x.device)

    if t.lin and idx is None:    # hoisted out of the chunk loop
        idx = [last_index(l, x.device)]

    def body(tc, consts, c, xs, keep=True):
        return _mamba_chunk_t(tc, consts, c, xs, causal, keep=keep,
                              idx=idx if (t.lin and keep) else None)

    _, (ys,) = t.checkpoint_loop(
        body, [st0],
        [t.permute(t.reshape(xh, b, nc, l, nh, headdim), 1, 0, 3, 2, 4),
         t.permute(t.reshape(bmat, b, nc, l, ssm_state), 1, 0, 2, 3),
         t.permute(t.reshape(cmat, b, nc, l, ssm_state), 1, 0, 2, 3),
         t.permute(t.reshape(dt, b, nc, l, nh), 1, 0, 3, 2)], [a], "chunks")
    y = t.reshape(t.permute(ys, 1, 0, 3, 2, 4), b, s, nh, headdim)
    y = t.add(y, t.mul(t.reshape(t.astype(p["d_skip"], f32), 1, 1, nh, 1),
                       xh))
    y = t.mul(t.astype(t.reshape(y, b, s, d_in), x.dtype), t.silu(z))
    with (t.dead() if not keep else contextlib.nullcontext()):
        return t.add(x, t.matmul(y, p["w_out"]))
