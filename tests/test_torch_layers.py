"""The port's layer functions against ``repro.models.layers`` on the same
inputs (numpy, seeded), at rtol = atol = 1e-5 in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.models import layers

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 3, 64), (1, 7, 128)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    (xj, xt), (sj, st) = _both(x), _both(scale)
    want = ref_layers.rms_norm(xj, {"scale": sj}, 1e-5)
    _close(layers.rms_norm(xt, st, 1e-5), want)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_rope_full(theta, head_dim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, head_dim)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    (xj, xt), (pj, pt) = _both(x), _both(pos)
    want = ref_layers.apply_rope(xj, pj, theta=theta, style="full")
    _close(layers.apply_rope(xt, pt, theta=theta, style="full"), want)


def test_apply_rope_unported_style_raises():
    x = torch.zeros(1, 1, 1, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.apply_rope(x, torch.zeros(1, 1), theta=1.0, style="mrope")


@pytest.mark.parametrize("rows", [1, 6])
def test_mlp(rows):
    rng = np.random.default_rng(2)
    d, f = 64, 128
    x = rng.standard_normal((rows, 3, d)).astype(np.float32)
    w = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    want = ref_layers.mlp(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in w.items()})
    got = layers.mlp(torch.from_numpy(x), torch.from_numpy(w["w_gate"]),
                     torch.from_numpy(w["w_up"]),
                     torch.from_numpy(w["w_down"]))
    _close(got, want)


def test_embed_and_lm_head():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((256, 64)).astype(np.float32) * 0.02
    w = rng.standard_normal((64, 256)).astype(np.float32) * 0.125
    tokens = rng.integers(0, 256, (3, 5)).astype(np.int32)
    want_x = ref_layers.embed(jnp.asarray(tokens),
                              {"table": jnp.asarray(table)})
    got_x = layers.embed(torch.from_numpy(tokens).long(),
                         torch.from_numpy(table))
    _close(got_x, want_x)
    want = ref_layers.lm_head(want_x, {"w": jnp.asarray(w)})
    _close(layers.lm_head(got_x, torch.from_numpy(w)), want)


def test_init_distributions_match_reference_scales():
    """The port's seeded init draws the reference's distributions: dense
    weights normal x fan_in^-0.5, embeddings x 0.02, norm scales ones."""
    gen = torch.Generator().manual_seed(0)
    m = layers.MLP(256, 512, torch.float32, "cpu")
    m.init(gen)
    assert abs(float(m.w_gate.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    assert abs(float(m.w_down.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    e = layers.Embedding(512, 64, torch.float32, "cpu")
    e.init(gen)
    assert abs(float(e.table.std()) - 0.02) < 0.001
    n = layers.RMSNorm(64, 1e-5, torch.float32, "cpu")
    n.init(gen)
    assert bool((n.scale == 1).all())
