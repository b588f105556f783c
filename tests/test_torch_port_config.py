"""The port's configs equal the JAX package's field for field: the model's
GAPartNetConfig, and the trainer's DataConfig, TrainerConfig and Config
with the yaml key tables."""

import dataclasses

import pytest

from gapartnet_tpu.constants import NUM_PART_CLASSES, SYMMETRY_INDICES
from gapartnet_tpu.models.gapartnet import GAPartNetConfig as JaxConfig
from gapartnet_tpu.train import config as jconfig
from gapartnet_tpu_torch import config as port_config
from gapartnet_tpu_torch.config import GAPartNetConfig as PortConfig
from gapartnet_tpu_torch.train import config as tconfig


def test_defaults_equal_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(PortConfig)]
    assert [n for n, _ in pf] == [n for n, _ in jf]
    assert pf == jf
    assert dataclasses.asdict(PortConfig()) == dataclasses.asdict(JaxConfig())


def test_constants_equal():
    assert port_config.NUM_PART_CLASSES == NUM_PART_CLASSES
    assert port_config.SYMMETRY_INDICES == tuple(SYMMETRY_INDICES)


@pytest.mark.parametrize("kw", [
    {},
    {"max_points": 512, "level_capacity_divisors": (1, 2, 4)},
    {"level_capacities": (20000, 14336, 4480, 1280, 384, 128, 10)},
])
def test_input_capacities_equal(kw):
    assert PortConfig(**kw).input_capacities() == JaxConfig(**kw).input_capacities()


def test_dataclass_fields_and_defaults_equal():
    for port, ref in ((tconfig.DataConfig, jconfig.DataConfig),
                      (tconfig.TrainerConfig, jconfig.TrainerConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(port)] == [
            (f.name, f.default) for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        f.name for f in dataclasses.fields(jconfig.Config)]
    assert tconfig._MODEL_KEY_MAP == jconfig._MODEL_KEY_MAP
    assert tconfig._INSTANCE_SEG_KEYS == jconfig._INSTANCE_SEG_KEYS
