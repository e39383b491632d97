"""Each fault a cell can have, planted under the timed path, turns
`correct` false, while the unbroken run at the same tiny size on the CPU
is correct. The harness's look for a chip is skipped; the rest of a run is
driven as on the card."""
import dataclasses

import pytest

from benchmark.tests.bench_tiny import run_tiny

TRAINER = "egogaussian_tpu_torch.parallel.scene_trainer"


def _unchanged_static(orig):
    def step(model, opt, *a, **k):
        out = orig(model, opt, *a, **k)
        return (model, opt) + tuple(out[2:])
    return step


def _loss_altered_static(orig):
    def step(model, opt, *a, **k):
        out = orig(model, opt, *a, **k)
        return out[:2] + (out[2] * 1.01,) + tuple(out[3:])
    return step


def _half_batch_static(orig):
    """Half of the frame's pixels left out of the gradient: the hand mask
    widened over the lower half of every frame."""
    def step(model, opt, batches, fidxs, grad_masks, *a, **k):
        masks = grad_masks.clone()
        masks[..., masks.shape[-2] // 2:, :] = 1.0
        return orig(model, opt, batches, fidxs, masks, *a, **k)
    return step


def _init_scales_small(orig):
    """The initial scales ten times too small."""
    def from_points(*a, **k):
        m = orig(*a, **k)
        p = dataclasses.replace(m.params, log_scales=m.params.log_scales - 2.302585)
        return dataclasses.replace(m, params=p)
    return from_points


def _densify_noop(orig):
    from benchmark.entries.train_static import _noop_densify
    return _noop_densify


def _densify_no_split(orig):
    def densify(*a, **k):
        return orig(*a, **dict(k, split=False))
    return densify


def _densify_no_clone(orig):
    def densify(*a, **k):
        return orig(*a, **dict(k, clone=False))
    return densify


def _split_draws_altered(orig):
    from benchmark.entries.train_static import _other_split_draws
    return _other_split_draws(orig)


CASES = [
    ("multi_scene_static_step", _unchanged_static),
    ("multi_scene_static_step", _loss_altered_static),
    ("multi_scene_static_step", _half_batch_static),
    ("from_points", _init_scales_small),
    ("densify_and_prune", _densify_noop),
    ("densify_and_prune", _densify_no_split),
    ("densify_and_prune", _densify_no_clone),
    ("densify_and_prune", _split_draws_altered),
]


def test_unbroken_run_is_correct():
    res = run_tiny("scene_static_std")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("name,fault", CASES, ids=[c[1].__name__.strip("_") for c in CASES])
def test_fault_is_not_correct(monkeypatch, name, fault):
    import importlib

    mod = importlib.import_module(TRAINER)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = run_tiny("scene_static_std")
    assert not res["correct"], res["checks"]
