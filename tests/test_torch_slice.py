"""The slice end to end: the function chip_smoke.py runs for the main path
(rSVD on A_exp and A_linear, RP-HOSVD and RP-ST-HOSVD on an Algorithm 3
tensor, each through f32 and the mixed-precision methods), here at a small
size on the CPU.  Every method's error must sit within the reference's
limits of the REFERENCE's f32 error on the same inputs: 1.5x (+1e-7) for
rSVD (tests/test_rsvd.py) and max(5x, 2e-5) for HOSVD
(tests/test_hosvd_lstsq.py)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hosvd as ref_hosvd
from repro.core import rsvd as ref_rsvd
from repro_torch import main_path
from repro_torch.configs.paper_randnla import PAPER_HOSVD, PAPER_RSVD

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)  # small shapes: leave the cores to the other test workers

RSVD_CFG = dataclasses.replace(PAPER_RSVD, n=256, rank=16)
HOSVD_CFG = dataclasses.replace(PAPER_HOSVD, dims=(32, 32, 32), ranks=(8, 8, 8))


@pytest.fixture(scope="module")
def port_errors():
    return main_path.run_main_path(RSVD_CFG, HOSVD_CFG, seed=0, device="cpu")


@pytest.fixture(scope="module")
def reference_f32_errors():
    """The reference's f32 errors on the port's inputs (its own Omega)."""
    errors = {}
    key = jax.random.PRNGKey(1)
    for name, a in main_path.rsvd_inputs(RSVD_CFG, seed=0, device="cpu").items():
        a = jnp.asarray(a.numpy())
        res = ref_rsvd.rsvd(key, a, RSVD_CFG.rank, oversample=RSVD_CFG.oversample,
                            method="f32")
        errors[("rsvd", name)] = float(ref_rsvd.reconstruction_error(a, res))
    t = jnp.asarray(main_path.hosvd_input(HOSVD_CFG, seed=0, device="cpu").numpy())
    for algo in main_path.HOSVD_ALGOS:
        res = getattr(ref_hosvd, algo)(key, t, HOSVD_CFG.ranks, method="f32")
        errors[(algo, "tensor")] = float(ref_hosvd.reconstruction_error(t, res))
    return errors


def test_main_path_covers_every_case(port_errors):
    expected = ({("rsvd", s, m) for s in main_path.SPECTRA
                 for m in main_path.RSVD_METHODS}
                | {(a, "tensor", m) for a in main_path.HOSVD_ALGOS
                   for m in main_path.HOSVD_METHODS})
    assert set(port_errors) == expected
    assert all(math.isfinite(e) and e > 0 for e in port_errors.values())


def test_main_path_within_port_f32_limits(port_errors):
    assert main_path.check_errors(port_errors) == []


def test_main_path_within_reference_f32_limits(port_errors, reference_f32_errors):
    over = {case: err for case, err in port_errors.items()
            if not err <= main_path.error_limit(
                case[0], reference_f32_errors[case[:2]])}
    assert not over, (over, reference_f32_errors)


@pytest.mark.parametrize("method", main_path.RSVD_METHODS)
def test_rsvd_error_matches_reference_f32_level(port_errors, reference_f32_errors,
                                                method):
    """The A_exp error is set by the spectrum's tail: every method lands
    within 1.5x of the reference's f32 error, and not below a tenth of it."""
    base = reference_f32_errors[("rsvd", "exp")]
    err = port_errors[("rsvd", "exp", method)]
    assert 0.1 * base <= err <= main_path.error_limit("rsvd", base)


def test_check_errors_reports_a_method_over_its_limit():
    errors = {("rsvd", "exp", "f32"): 1e-4, ("rsvd", "exp", "shgemm"): 2e-4,
              ("rp_hosvd", "tensor", "f32"): 1e-6,
              ("rp_hosvd", "tensor", "shgemm_fused"): 1e-5}
    failures = main_path.check_errors(errors)
    assert len(failures) == 1 and failures[0].startswith("rsvd/exp/shgemm")


def test_inputs_are_seeded():
    a1 = main_path.rsvd_inputs(RSVD_CFG, seed=3, device="cpu")["linear"]
    a2 = main_path.rsvd_inputs(RSVD_CFG, seed=3, device="cpu")["linear"]
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    assert a1.shape == (RSVD_CFG.n, RSVD_CFG.n)
