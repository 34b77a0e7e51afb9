"""The port's configuration (marlin_tpu_torch/config) against the JAX
package's: the same fields with the same defaults, the same override and
error behaviour, and the precision scope that stands in for the
``precision=`` argument of ``jnp.dot``."""

import dataclasses

import numpy as np
import pytest
import torch

from marlin_tpu import config as jconfig
from marlin_tpu_torch import config as pconfig


def test_fields_and_defaults_match_the_jax_package():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.MarlinConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.MarlinConfig)}
    assert list(pf) == list(jf)  # the same fields in the same order
    for name, default in jf.items():
        if name == "default_dtype":
            assert pf[name] == torch.float32
            assert np.dtype(default) == np.float32
        else:
            assert pf[name] == default, name


def test_set_config_and_override():
    cfg = pconfig.get_config()
    assert cfg is pconfig.get_config()
    with pconfig.config_override(matmul_precision="default",
                                 lu_base_size=64) as inner:
        assert inner is cfg
        assert (cfg.matmul_precision, cfg.lu_base_size) == ("default", 64)
    assert (cfg.matmul_precision, cfg.lu_base_size) == ("highest", 1000)
    with pytest.raises(ValueError, match="unknown config field"):
        pconfig.set_config(no_such_field=1)
    with pytest.raises(ValueError, match="unknown config field"):
        jconfig.set_config(no_such_field=1)


@pytest.mark.parametrize("precision,torch_name", [
    ("highest", "highest"), ("high", "high"), ("default", "medium")])
def test_matmul_precision_scope_sets_and_restores(precision, torch_name):
    before = torch.get_float32_matmul_precision()
    with pconfig.matmul_precision_scope(precision):
        assert torch.get_float32_matmul_precision() == torch_name
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(RuntimeError):
        with pconfig.matmul_precision_scope(precision):
            raise RuntimeError("restored on the way out too")
    assert torch.get_float32_matmul_precision() == before


def test_precision_scopes_follow_the_config():
    before = torch.get_float32_matmul_precision()
    with pconfig.config_override(matmul_precision="high",
                                 linalg_precision="default"):
        with pconfig.matmul_precision_scope():
            assert torch.get_float32_matmul_precision() == "high"
        with pconfig.linalg_precision_scope():
            assert torch.get_float32_matmul_precision() == "medium"
    assert torch.get_float32_matmul_precision() == before
    with pytest.raises(ValueError, match="unknown matmul precision"):
        with pconfig.matmul_precision_scope("tf32"):
            pass


def test_enable_x64_switches_the_default_dtypes():
    cfg = pconfig.get_config()
    assert not pconfig.x64_enabled() and cfg.default_dtype == torch.float32
    try:
        pconfig.enable_x64()
        assert pconfig.x64_enabled() and cfg.default_dtype == torch.float64
    finally:
        pconfig._x64 = False
        pconfig.set_config(default_dtype=torch.float32)
