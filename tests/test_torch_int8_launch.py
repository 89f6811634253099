"""The int8 small-M matmul's launch plan and per-weight launch state
(ddl_tpu_torch/ops/int8_matvec.py, models/transformer.py ``_Int8Weight``):
the plan stays within the H100's limits at every call site of the 124M
decode for M = 1-8, covers the weight exactly, and agrees with
``int8_kernel_takes``; a module builds its ``Int8MatmulLaunch`` once and a
new one after a strict load (int8 -> f32 -> int8) or a device move, so it
never multiplies by a weight it no longer holds.  On the CPU the launch
state runs the plain version, which is what it is compared with here."""

import numpy as np
import pytest
import torch

from ddl_tpu_torch.models import transformer as tt
from ddl_tpu_torch.ops._build import H100_SMS, SMEM_PER_BLOCK
from ddl_tpu_torch.ops.int8_matvec import (
    MATVEC_MAX_ROWS,
    Int8MatmulLaunch,
    int8_kernel_takes,
    int8_matmul_small_m,
    int8_matmul_small_m_plain,
    matvec_plan,
)
from ddl_tpu_torch.ops.quant import quantize_q8

# (D, O, contract_last): q/out and MHA k/v, GQA k/v, wi, wo, the head
CALL_SITES = {"q, out": (768, 768, False), "GQA k, v": (768, 256, False),
              "wi": (768, 3072, False), "wo": (3072, 768, False), "head": (768, 50304, True)}


@pytest.mark.parametrize("site", CALL_SITES)
def test_plan_within_the_cards_limits_at_every_call_site(site):
    d, o, last = CALL_SITES[site]
    plan = matvec_plan(d, o, last)
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    for m in range(1, MATVEC_MAX_ROWS + 1):
        assert plan.smem(m) <= SMEM_PER_BLOCK
        assert int8_kernel_takes(m, d, last, torch.bfloat16, "cuda")
    if last:
        # a persistent grid of at most two CTAs an SM, each with rows, and a
        # ring of whole consumer passes of 16-byte-aligned rows
        assert 1 <= plan.grid <= 2 * H100_SMS and o // plan.grid >= 4
        assert 2 * plan.smem(1) <= SMEM_PER_BLOCK  # two share an SM at M = 1
        assert plan.pitch >= d and plan.pitch % 16 == 0 and plan.rows % 4 == 0
        assert plan.stages >= 2 and plan.stages * plan.rows * plan.pitch >= 64 * 1024
    else:
        # strips of 64 columns cover O; the 8 ranks' slices of whole 32-row
        # boxes cover D, none of them wholly past it
        assert plan.grid * 64 >= o > (plan.grid - 1) * 64
        assert plan.rows % 32 == 0 and plan.stages == plan.rows // 32
        assert 8 * plan.rows >= d > 8 * plan.rows - 32 * 8
        assert plan.ctas >= H100_SMS // 5  # the smallest call still spreads out


@pytest.mark.parametrize("d", [64, 768, 3072, 8192, 32768, 65536])
@pytest.mark.parametrize("last", [False, True], ids=["DxO", "OxD"])
def test_gate_agrees_with_the_plan(d, last):
    plan = matvec_plan(d, 1000, last)
    for m in range(1, MATVEC_MAX_ROWS + 2):
        taken = m <= MATVEC_MAX_ROWS and plan.smem(m) <= SMEM_PER_BLOCK
        for dtype in (torch.bfloat16, torch.float32):
            assert int8_kernel_takes(m, d, last, dtype, "cuda") is taken
        assert int8_kernel_takes(m, d, last, torch.float16, "cuda") is False
        assert int8_kernel_takes(m, d, last, torch.float16, "cpu") is (m <= MATVEC_MAX_ROWS)


def _int8_state(rng, d, o, last):
    w = torch.from_numpy(rng.standard_normal((o, d) if last else (d, o)).astype(np.float32))
    w8, scale = quantize_q8(w, axis=1 if last else 0)
    return w, w8, scale


@pytest.mark.parametrize("last", [False, True], ids=["QDense", "LMHead"])
def test_launch_state_is_rebuilt_after_a_load_and_a_device_move(last):
    rng = np.random.default_rng(0)
    d, o = 32, 48
    if last:
        module = tt.LMHead(tt.LMConfig(vocab_size=o, d_model=d))
    else:
        module = tt.QDense(d, o, torch.float32)
    x = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))

    def check(w8, scale):
        counts = int8_matmul_small_m.launches
        with torch.no_grad():
            got = module(x)
        state = module._launch
        assert state is not None and state.w8 is module.kernel and state.scale is module.scale
        assert state.matches(module.kernel, module.scale)
        torch.testing.assert_close(
            got, int8_matmul_small_m_plain(x, w8, scale, contract_last=last), rtol=0, atol=0)
        assert int8_matmul_small_m.launches == counts  # the plain version on the CPU
        return state

    _, w8, scale = _int8_state(rng, d, o, last)
    module.load_state_dict({"kernel": w8, "scale": scale})
    first = check(w8, scale)
    with torch.no_grad():
        module(x)
    assert module._launch is first  # built once, reused
    # a strict load of an f32 kernel, then of other int8 weights
    w, _, _ = _int8_state(rng, d, o, last)
    module.load_state_dict({"kernel": w})
    assert module._launch is None and not module.quantized
    _, w8b, scaleb = _int8_state(rng, d, o, last)
    module.load_state_dict({"kernel": w8b, "scale": scaleb})
    assert module._launch is None
    second = check(w8b, scaleb)
    assert second is not first and not first.matches(module.kernel, module.scale)
    # a cast or device move replaces the tensors: no state survives it
    module.to(torch.float64)
    assert module._launch is None
    module.to("meta")
    assert module._launch is None


def test_launch_state_checks_the_weight_once_and_x_on_each_call():
    rng = np.random.default_rng(1)
    _, w8, scale = _int8_state(rng, 16, 24, False)
    with pytest.raises(ValueError, match="scale has"):
        Int8MatmulLaunch(w8, scale[:, :23])
    state = Int8MatmulLaunch(w8, scale)
    assert not state.matches(w8.clone(), scale) and not state.matches(w8, scale.clone())
    x = torch.from_numpy(rng.standard_normal((MATVEC_MAX_ROWS, 16)).astype(np.float32))
    torch.testing.assert_close(state(x), int8_matmul_small_m_plain(x, w8, scale), rtol=0, atol=0)
    with pytest.raises(ValueError, match="large-M"):
        state(torch.zeros(MATVEC_MAX_ROWS + 1, 16))
