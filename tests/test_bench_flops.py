"""Sanity of bench.py's analytic FLOPs model (the MFU numerator): computed
from the real weight shapes, it must match a hand calculation at the
production conf."""

import sys
import os

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_analytic_flops_match_hand_calc():
    from bench import analytic_step_flops
    from rnb_tpu.models import fields
    from rnb_tpu.models.renderer import RendererConfig

    statics = fields.ModelStatics(sdf=fields.SDFConfig(),
                                  color=fields.RenderingConfig(),
                                  nerf=fields.NeRFConfig())
    params = fields.init_model_bundle(jax.random.PRNGKey(0), statics)
    rcfg = RendererConfig()
    fl = analytic_step_flops(params, statics, rcfg, bsz=512)

    # hand calc: SDF pass = 2*(39*256 + 6*256*256 + 256*217 + 256*257) MACs
    f_sdf = 2 * (39 * 256 + 6 * 256 * 256 + 256 * 217 + 256 * 257)
    f_alb = 2 * (310 * 256 + 256 * 256 + 256 * 3)
    f_sdf_only = f_sdf - 2 * 256 * 256
    n_core = 512 * 128
    n_up = 512 * 64 + 512 * 16 * 3
    expect = n_core * (6 * f_sdf + 3 * f_alb) + n_up * f_sdf_only
    assert abs(fl["model"] - expect) / expect < 1e-9


def test_device_peaks_table():
    """The roofline peaks come from one table keyed by device_kind; a device
    that is not in it is an error, not a default."""
    from bench import device_peaks
    h100 = device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["bf16_flops"] == 989e12 and h100["tf32_flops"] == 495e12
    assert h100["fp32_flops"] == 67e12 and h100["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("NVIDIA A100-SXM4-80GB")


def test_bench_refuses_cpu():
    """bench.py reports device numbers only from the card."""
    from bench import device_info
    with pytest.raises(SystemExit, match="no GPU"):
        device_info()
