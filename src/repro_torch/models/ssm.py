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
