"""The port's reference-checkpoint converter against the JAX package's
`convert_reference_state_dict` followed by `weights.params_from_jax`:
tensor for tensor, exactly, on a synthetic reference state_dict (the one
tests/test_ckpt_convert.py builds), in both spatial orders, and on a staged
checkpoint without the NPCS head."""

import numpy as np
import pytest
import torch

from gapartnet_tpu.train.ckpt_convert import convert_reference_state_dict as jax_convert
from gapartnet_tpu_torch.config import GAPartNetConfig
from gapartnet_tpu_torch.models.gapartnet import GAPartNet
from gapartnet_tpu_torch.train.ckpt_convert import convert_reference_state_dict, load_reference_ckpt
from gapartnet_tpu_torch.weights import params_from_jax
from tests.test_ckpt_convert import make_reference_state_dict


def _expected(sd, **kw):
    params, stats = jax_convert(sd, **kw)
    return params_from_jax({"params": params, "batch_stats": stats})


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("spatial_order", ["xyz", "zyx"])
@pytest.mark.parametrize("channels,block_repeat", [((8, 16), 2), ((8, 16, 24), 1)])
def test_convert_equals_jax_then_params_from_jax(channels, block_repeat, spatial_order):
    sd = make_reference_state_dict(channels=channels, block_repeat=block_repeat)
    kw = dict(channels=channels, block_repeat=block_repeat, spatial_order=spatial_order)
    got = convert_reference_state_dict(sd, **kw)
    _assert_equal(got, _expected(sd, **kw))
    # it loads into the port's model, every parameter and statistic covered
    model = GAPartNet(GAPartNetConfig(channels=channels, block_repeat=block_repeat))
    model.load_state_dict(got, strict=True)


def test_staged_checkpoint_without_npcs_head(tmp_path):
    sd = make_reference_state_dict(channels=(8, 16))
    sd = {k: v for k, v in sd.items() if not k.startswith("npcs")}
    got = convert_reference_state_dict(sd, channels=(8, 16))
    _assert_equal(got, _expected(sd, channels=(8, 16)))
    assert not any(k.startswith("npcs") for k in got) and "score_head.weight" in got
    model = GAPartNet(GAPartNetConfig(channels=(8, 16)))
    missing, unexpected = model.load_state_dict(got, strict=False)
    assert not unexpected and missing and all(k.startswith("npcs_") for k in missing)
    # a Lightning-style file round-trips through load_reference_ckpt
    full = make_reference_state_dict(channels=(8, 16))
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in full.items()},
                "epoch": 3}, tmp_path / "ref.ckpt")
    _assert_equal(load_reference_ckpt(str(tmp_path / "ref.ckpt"), channels=(8, 16)),
                  _expected(full, channels=(8, 16)))
