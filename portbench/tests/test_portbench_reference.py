"""The plain float64 reference against the port's CPU path (float64) at a
tiny size: lnpost and the posterior-mean images.  The reference imports
nothing of the port; this test imports both."""
import json
import math

import numpy as np
import pytest
import torch

from portbench.harness.inputs import make_inputs
from portbench.reference.posterior import param_names, tf32_round

from portbench_support import TINY


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    from psfmc_tpu_torch.models import MultiComponentModel

    with open(TINY) as fh:
        cfg = json.load(fh)
    inputs = make_inputs(cfg, 2**31 + 77, 3, str(tmp_path_factory.mktemp("field")), "cpu")
    model = MultiComponentModel(inputs.model_files[1], device="cpu", dtype=torch.float64)
    thetas = model.init_params_from_priors(24, random_state=np.random.RandomState(3))
    named, pos = {}, 0
    for name, ln in zip(model.param_names, model.param_lens):
        named[name] = thetas[:, pos] if ln == 1 else thetas[:, pos:pos + ln]
        pos += ln
    return cfg, inputs, model, thetas, named


def test_parameter_names_are_the_trace_databases(field):
    cfg, _, model, _, _ = field
    assert sorted(n for n, _ in param_names(cfg["components"])) == sorted(model.param_names)


def test_mask_is_the_region_files(field):
    _, inputs, model, _, _ = field
    assert np.array_equal(inputs.bad_mask, model.spec.bad_px)


def test_lnpost_matches_the_ports_float64_path(field):
    _, inputs, model, thetas, named = field
    want = model.posterior_fns.log_posterior_batch(torch.as_tensor(thetas)).numpy()
    got = inputs.reference([1]).log_posterior(named)
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    # the port interpolates the Sersic b_n from a table (relative error
    # below 1e-7); the reference solves it exactly
    assert np.max(np.abs(got[fin] - want[fin]) / np.abs(want[fin])) < 1e-8


def test_stack_target_picks_each_walkers_observation(field):
    _, inputs, _, _, named = field
    stack = inputs.reference()
    target = np.arange(24) % 3
    got = stack.log_posterior(named, target=target)
    for k in range(3):
        one = inputs.reference([k]).log_posterior({n: v[target == k] for n, v in named.items()})
        assert np.allclose(got[target == k], one, rtol=1e-13)


def test_mean_images_match_the_ports_replay(field):
    _, inputs, model, thetas, named = field
    fin = np.isfinite(model.posterior_fns.log_posterior_batch(torch.as_tensor(thetas)).numpy())
    want = model.replay_posterior_means(thetas[fin])
    got = inputs.reference([1]).mean_images({n: v[fin] for n, v in named.items()})
    for kind, img in got.items():
        scale = np.abs(got[kind]).max()
        assert np.max(np.abs(img - want[kind])) <= 1e-9 * scale, kind


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, math.pi],
                     dtype=torch.float32)
    got = tf32_round(x)
    assert got[:2].tolist() == [1.0, 1.0 + 2 ** -10]
    assert got[2].item() == 1.0  # a tie rounds to even
    assert got[3].item() == 1.0 + 2 ** -9
    assert abs(got[4].item() - math.pi) <= 2 ** -11 * 2


def test_the_control_errs_far_more_than_float32(field):
    _, inputs, _, _, named = field
    ref, ctrl = inputs.reference([1]), inputs.reference([1], "tf32")
    want = ref.log_posterior(named)
    fin = np.isfinite(want)
    gap = np.abs(ctrl.log_posterior(named)[fin] - want[fin]) / np.maximum(
        np.abs(want[fin]), ref.normalization()[0])
    assert gap.max() > 1e-5
