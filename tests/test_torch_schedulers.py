"""The port's learning-rate schedules against the JAX package's: five
schedules times a spread of steps (warm-up, cycle boundaries, past the end),
through the factories and through ``get_schedule``. The port computes in
numpy float32 like the reference; ``cos`` and ``pow`` come from another
library, hence 1e-6. The chill plateau's noise is the port's own generator:
inside chill windows only its range and determinism are held."""

import numpy as np
import pytest

from whisper_finetune_tpu.optim import schedulers as js
from whisper_finetune_torch.optim import schedulers as ts

STEPS = [0, 1, 7, 9, 10, 11, 49, 50, 51, 99, 100, 101, 149, 150, 199, 200, 201, 250]
CONFS = {
    "linear": {"type": "linear", "warmup_steps": 10},
    "cosine": {"type": "cosine", "warmup_steps": 10},
    "cosine_with_restarts": {"type": "cosine_with_restarts", "warmup_steps": 10,
                             "lr_num_cycles": 3},
    "cosine_with_warmup_restarts": {"type": "cosine_with_warmup_restarts", "warmup_steps": 10,
                                    "lr_num_cycles": 4, "lr_gamma": 0.8},
    "cosine_with_warmup_restarts_chill": {
        "type": "cosine_with_warmup_restarts_chill", "warmup_steps": 10, "lr_num_cycles": 4,
        "lr_gamma": 0.8, "chill_steps": 20, "chill_range": 0.02},
}
TRAIN_STEPS = 200


def _in_chill(step, conf):
    cycle_length = TRAIN_STEPS / conf["lr_num_cycles"]
    in_cycle = step % cycle_length
    return (in_cycle >= conf["warmup_steps"]
            and cycle_length - in_cycle < conf["chill_steps"]
            and step // cycle_length < conf["lr_num_cycles"] - 1
            and step < TRAIN_STEPS)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("name", sorted(CONFS))
def test_schedule_matches_jax(name, step):
    conf = CONFS[name]
    got = ts.get_schedule(conf, TRAIN_STEPS)(step)
    want = float(js.get_schedule(conf, TRAIN_STEPS)(step))
    assert isinstance(got, float)
    if name.endswith("chill") and _in_chill(step, conf):
        # Same plateau, another generator's noise: both within the range.
        assert abs(got - want) <= 2 * conf["chill_range"] + 1e-6
    else:
        assert got == pytest.approx(want, abs=1e-6)


def test_chill_plateau_noise():
    conf = CONFS["cosine_with_warmup_restarts_chill"]
    fn = ts.get_schedule(conf, TRAIN_STEPS)
    steps = [s for s in range(TRAIN_STEPS) if _in_chill(s, conf)]
    assert len(steps) == 3 * 19  # the last cycle has no plateau
    vals = np.array([fn(s) for s in steps])
    assert np.array_equal(vals, np.array([fn(s) for s in steps]))  # keyed by the step
    first = vals[:19]
    plateau = first - np.array([ts.chill_noise(s, conf["chill_range"]) for s in steps[:19]])
    np.testing.assert_allclose(plateau, plateau[0], atol=1e-7)  # one frozen value a cycle
    noise = np.array([ts.chill_noise(s, 0.02) for s in range(2000)])
    assert np.abs(noise).max() <= 0.02 and np.abs(noise).max() > 0.019
    assert abs(noise.mean()) < 2e-3 and len(np.unique(noise)) == 2000
    # and the JAX plateau is the same frozen value
    jfn = js.get_schedule(conf, TRAIN_STEPS)
    assert abs(float(jfn(steps[0])) - plateau[0]) <= conf["chill_range"] + 1e-6


def test_factory_defaults_and_errors():
    assert ts.cosine_with_warmup(0, 100)(50) == pytest.approx(
        float(js.cosine_with_warmup(0, 100)(50)), abs=1e-6)
    assert ts.linear_with_warmup(0, 0)(0) == pytest.approx(
        float(js.linear_with_warmup(0, 0)(0)), abs=1e-6)
    with pytest.raises(ValueError, match="Unknown learning rate scheduler"):
        ts.get_schedule({"type": "nope", "warmup_steps": 0}, 10)
