"""``Model.init``'s draw of leaves too large to draw whole: a layer slice
of more than ``model.DRAW_WHOLE_MAX`` elements (arctic-480b's expert
leaves, [128, 7168, 4864] a layer) is drawn one slice of its leading axis
at a time, in order, from the same generator, at the leaf's fan-in scale;
every other leaf is drawn a layer at a time as before, so every other
model's weights keep their bits.

The full-width configurations are walked on the ``meta`` device with
``torch.randn`` recorded (no memory is drawn); the SMOKE ones are drawn
on the CPU."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (  # noqa: E402
    get_config, get_smoke_config, list_archs)
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import tree  # noqa: E402


def _draws(monkeypatch, cfg, device="meta"):
    """The shapes ``Model.init`` asks ``torch.randn`` for, in order, and
    the tree it builds (on ``meta``: shapes only, nothing allocated)."""
    shapes = []
    randn = torch.randn

    def spy(shape, *a, **kw):
        shapes.append(tuple(shape))
        if device == "meta":
            return torch.empty(shape, dtype=torch.float32, device="meta")
        return randn(shape, *a, **kw)

    monkeypatch.setattr(torch, "randn", spy)
    params = build_model(cfg, device=device).init(torch.Generator())
    monkeypatch.setattr(torch, "randn", randn)
    return shapes, params


@pytest.mark.parametrize("arch", list_archs())
def test_full_width_draws_stay_under_the_threshold(monkeypatch, arch):
    """At full width no draw is over ``DRAW_WHOLE_MAX`` elements.  Only
    arctic-480b's three expert leaves are cut: 35 x 128 slices each,
    [7168, 4864] or [4864, 7168]; every other model's sequence of draws
    is the one it has with no threshold at all."""
    cfg = get_config(arch)
    shapes, _ = _draws(monkeypatch, cfg)
    assert max(map(math.prod, shapes)) <= model_mod.DRAW_WHOLE_MAX
    monkeypatch.setattr(model_mod, "DRAW_WHOLE_MAX", math.inf)
    whole, _ = _draws(monkeypatch, cfg)
    if arch != "arctic-480b":
        assert shapes == whole
        return
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    L, E = cfg.num_layers, cfg.moe.num_experts
    assert len(shapes) - len(whole) == 3 * L * (E - 1)
    assert shapes.count((d, fe)) - whole.count((d, fe)) == 2 * L * E
    assert shapes.count((fe, d)) - whole.count((fe, d)) == L * E
    assert max(map(math.prod, whole)) == E * d * fe       # 4.46e9


def test_sliced_leaf_draws_its_slices_in_order(monkeypatch):
    """With the threshold lowered under one layer slice of SMOKE
    arctic's experts ([8, 64, 96]), each expert leaf is drawn one expert
    at a time: its slice [l, e] is the generator's next draw of the
    expert's shape, times the fan-in scale, in (layer, expert) order."""
    cfg = get_smoke_config("arctic-480b")
    d, fe = cfg.d_model, cfg.moe.d_ff_expert
    L, E = cfg.num_layers, cfg.moe.num_experts
    monkeypatch.setattr(model_mod, "DRAW_WHOLE_MAX", E * d * fe - 1)
    shapes, params = _draws(monkeypatch, cfg, device="cpu")
    g = torch.Generator()
    replay = [torch.randn(s, generator=g, dtype=torch.float32)
              for s in shapes]
    dt = params["layers"]["moe"]["wi_gate"].dtype
    for name, shape, fan_in in (("wi_gate", (d, fe), d),
                                ("wi_up", (d, fe), d), ("wo", (fe, d), fe)):
        leaf = params["layers"]["moe"][name]
        assert tuple(leaf.shape) == (L, E) + shape
        first = next(i for i, x in enumerate(replay)
                     if x.shape == shape and torch.equal(
                         (x * fan_in ** -0.5).to(dt), leaf[0, 0]))
        assert shapes[first:first + L * E] == [shape] * (L * E)
        for k in range(L * E):
            want = (replay[first + k] * fan_in ** -0.5).to(dt)
            assert torch.equal(leaf[k // E, k % E], want), (name, k)


@pytest.mark.parametrize("arch", list_archs())
def test_models_under_the_threshold_draw_bit_identical_weights(monkeypatch,
                                                               arch):
    """Each SMOKE model drawn on the CPU: the same bits with the default
    threshold as with none (a whole layer slice a draw, each scaled
    ``x * s`` as before the in-place scale)."""
    cfg = get_smoke_config(arch)
    _, now = _draws(monkeypatch, cfg, device="cpu")
    monkeypatch.setattr(model_mod, "DRAW_WHOLE_MAX", math.inf)
    _, whole = _draws(monkeypatch, cfg, device="cpu")
    got, want = tree.flatten(now)[0], tree.flatten(whole)[0]
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = torch.randn((cfg.d_model, cfg.d_model), generator=torch.Generator())
    s = cfg.d_model ** -0.5
    assert torch.equal(x * s, x.clone().mul_(s))
