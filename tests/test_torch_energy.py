"""Port parity: the paper's analytic energy / area model
(``repro_torch.core.energy_model`` against ``repro.core.energy_model``).

Both are numpy; every public function must return the reference's
numbers exactly over a grid of engines x q x mu x k x activation types
(the model is the paper's 28-nm analysis, not a measurement of any
chip)."""
import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import energy_model as jem
from repro_torch.core import energy_model as tem

ENGINES = ["FPE", "iFPU", "FIGNA", "FIGLUT-F", "FIGLUT-I"]
ACTS = ["fp16", "bf16", "fp32"]


def test_constants_equal():
    assert dataclasses.asdict(tem.TECH) == dataclasses.asdict(jem.TECH)
    assert tem.ACT_BITS == jem.ACT_BITS and tem.ACT_MANT == jem.ACT_MANT
    assert tem.OPT_DIMS == jem.OPT_DIMS
    for m in tem.OPT_DIMS:
        assert tem.opt_layer_gemms(m) == jem.opt_layer_gemms(m)


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_cfg_and_area(engine):
    for mu, k in itertools.product((2, 4, 8), (8, 32, 64)):
        assert dataclasses.asdict(tem.engine_cfg(engine, mu, k)) == \
            dataclasses.asdict(jem.engine_cfg(engine, mu, k))
    for q, act, mu, k in itertools.product((2, 3, 4, 8), ACTS, (2, 4),
                                           (16, 32)):
        assert tem.engine_area_mm2(engine, q, act, mu, k) == \
            jem.engine_area_mm2(engine, q, act, mu, k)


def test_lut_primitives():
    for mu, ab, k, half in itertools.product((2, 3, 4, 6, 8), (16, 32),
                                             (1, 8, 32, 128),
                                             (True, False)):
        assert tem.fflut_read_energy(mu, ab, k, half=half) == \
            jem.fflut_read_energy(mu, ab, k, half=half)
        assert tem.fflut_static_energy_per_cycle(mu, ab, half=half) == \
            jem.fflut_static_energy_per_cycle(mu, ab, half=half)
        assert tem.rflut_read_energy(mu, ab) == jem.rflut_read_energy(mu, ab)
        for is_int in (True, False):
            assert tem.lut_generation_energy(mu, ab, is_int, half=half) \
                == jem.lut_generation_energy(mu, ab, is_int, half=half)


@pytest.mark.parametrize("engine", ENGINES)
def test_gemm_and_model_reports(engine):
    for q, act, mu, k in itertools.product((1, 2, 2.4, 3, 4, 8), ACTS,
                                           (2, 4), (16, 32)):
        qi = int(np.ceil(q))
        assert tem.pe_energy_per_mac(engine, qi, act, mu, k) == \
            jem.pe_energy_per_mac(engine, qi, act, mu, k)
        for resident in (False, True):
            a = tem.gemm_report(engine, 4096, 4096, 32, q, act, mu, k,
                                weight_resident=resident)
            b = jem.gemm_report(engine, 4096, 4096, 32, q, act, mu, k,
                                weight_resident=resident)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.row() == b.row()
    for model in ("opt-125m", "opt-6.7b", "opt-30b"):
        for q in (2, 3, 4):
            a = tem.model_report(engine, model, 8, q)
            b = jem.model_report(engine, model, 8, q)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
