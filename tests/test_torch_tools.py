"""The H100 micro-benchmarks' plain versions against the TPU scripts' own
Pallas kernels, run in interpret mode, and each micro-benchmark's `run` on
the CPU.

The TPU scripts under `tools/` are not a package: each is loaded by path
with importlib, and its shape constants are set on the loaded module at tiny
values (B 2, N 24-40, and N 300 for `rowtile`'s two 256-row query tiles, H
4 heads of 64 so that a head pair is 128 lanes, K 64, F 256, BM 64, S 16).
The seven `pallas_call` sites:

- `build_jouter`, `build_scratch` (bench_ln_matmul.py) against
  `ln_matmul_bias_act_reference`: both sides round the LN output and the
  activation to bf16 at the same points; the TPU's GELU uses its own erf
  (a tanh form for a bf16 output) where torch uses erf: one bf16 ulp of
  the largest value;
- `build_variant`, `build_multi` (bench_packed_attn.py) and `build`
  (bench_attn_variants.py) against `packed_attention_variant_reference`
  with the same flags: the same one-shot softmax and rounding points, fp32
  sums in another order: one bf16 ulp of the largest output, taken at
  its own scale (means of 0.3 randn, of order 0.01-0.1), not floored at 1;
- `_pallas_mm` (bench_int8_pallas.py) against `tc_matmul_reference`: int8
  exact; bf16 with fp32 sums in another order, 1e-5 of the largest value;
- `chain` (bench_vpu_bf16.py) against `elementwise_chain_reference` in its
  three modes. In bf16 math every op rounds once on both sides: bit for
  bit. In fp32 math XLA on the CPU contracts `v * 1.0001 + 1e-4` into one
  FMA, which rounds once where the port (kernel and plain version alike)
  rounds the product and the sum: at most one fp32 rounding of values
  below 1 a rep, 2^-24, carried through the rep's factors of ~1, so 6 reps
  stay within 6 x 2^-23; a bf16 output may then round one bf16 ulp (2^-8
  below 1) apart. On NaN, ±inf and values outside [0, 1] both keep NaN
  (`jnp.clip`, `torch.clamp`) in the same places, and the rest is held as
  above.

And the wrappers of the two tensor-core kernels of row 13,
`packed_attention_variant` and `tc_matmul`, refusing what their kernels
do not take before any build or launch. Then the two tools that measure
the eval sweeps and the host's input pipeline, `bench_eval` and
`bench_host_pipeline`, through their command lines on the CPU.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from video_rep_learning_tpu_torch.ops import attention, int8_matmul
from video_rep_learning_tpu_torch.ops.attention import \
    packed_attention_variant_reference
from video_rep_learning_tpu_torch.ops.elementwise_chain import \
    elementwise_chain_reference
from video_rep_learning_tpu_torch.ops.int8_matmul import tc_matmul_reference
from video_rep_learning_tpu_torch.ops.matmul import ln_matmul_bias_act_reference
from video_rep_learning_tpu_torch.tools import (bench_attn_variants,
                                                bench_int8_pallas,
                                                bench_ln_matmul,
                                                bench_packed_attn,
                                                bench_vpu_bf16)

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "tools")


@pytest.fixture
def tpu_interpret(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        yield


def load_tool(monkeypatch, name, **consts):
    """tools/<name>.py loaded by path, with its shape constants set."""
    spec = importlib.util.spec_from_file_location(f"tpu_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    return mod


def bf16_ulps(want, ulps=1):
    """`ulps` bf16 ulps of the largest |value|, at the output's own scale
    (attention outputs here are of order 0.01-0.1)."""
    return ulps * 2.0 ** -7 * float(np.abs(want).max())


def to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("build", ["build_jouter", "build_scratch"])
def test_ln_matmul_schedules_match_plain(tpu_interpret, monkeypatch, build):
    B, N, K, F = 2, 24, 64, 256
    mod = load_tool(monkeypatch, "bench_ln_matmul", B=B, N=N, K=K, F=F)
    rng = np.random.RandomState(0)
    x = rng.randn(B, N, K).astype(np.float32)
    g = (1 + 0.1 * rng.randn(K)).astype(np.float32)
    be = (0.1 * rng.randn(K)).astype(np.float32)
    w = (rng.randn(K, F) * 0.03).astype(np.float32)
    b = (rng.randn(F) * 0.03).astype(np.float32)
    dt = jnp.bfloat16
    call = getattr(mod, build)(dt)
    want = to_np(call(jnp.asarray(x, dt), jnp.asarray(g)[None], jnp.asarray(be)[None],
                      jnp.asarray(w, dt), jnp.asarray(b)[None]))
    got = ln_matmul_bias_act_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(g), torch.from_numpy(be),
        torch.from_numpy(w).t().contiguous().bfloat16(), torch.from_numpy(b),
        "gelu_exact")
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= bf16_ulps(want), err


def _qkv(B, N, H, seed=0):
    return (np.random.RandomState(seed).randn(B, N, 3 * H * 64) * 0.3).astype(np.float32)


def _check_attention(want, qkv, H, **flags):
    got = packed_attention_variant_reference(torch.from_numpy(qkv).bfloat16(), H, **flags)
    err = float(np.abs(got.float().numpy() - to_np(want)).max())
    assert err <= bf16_ulps(to_np(want)), (flags, err)


# the TPU main()'s build_variant forms: (exp2, nomax, head pairs a program)
@pytest.mark.parametrize("exp2,nomax,gpp", [(True, False, 1), (True, True, 1),
                                            (True, True, 2), (False, True, 1)])
def test_packed_attention_build_variant_matches_plain(tpu_interpret, monkeypatch,
                                                      exp2, nomax, gpp):
    B, N, H = 2, 24, 4
    mod = load_tool(monkeypatch, "bench_packed_attn", B=B, N=N, H=H, D=H * 64)
    qkv = _qkv(B, N, H)
    call = mod.build_variant(exp2=exp2, nomax=nomax, batched=False, gpp=gpp)
    _check_attention(call(jnp.asarray(qkv, jnp.bfloat16)), qkv, H, exp2=exp2,
                     nomax=nomax, bf16p=False)


@pytest.mark.parametrize("imgs,bf16p", [(2, False), (2, True), (1, True)])
def test_packed_attention_build_multi_matches_plain(tpu_interpret, monkeypatch,
                                                    imgs, bf16p):
    B, N, H = 2, 24, 4
    mod = load_tool(monkeypatch, "bench_packed_attn", B=B, N=N, H=H, D=H * 64)
    qkv = _qkv(B, N, H, 1)
    call = mod.build_multi(imgs, bf16p=bf16p)
    _check_attention(call(jnp.asarray(qkv, jnp.bfloat16)), qkv, H, exp2=True,
                     nomax=True, bf16p=bf16p)


@pytest.mark.parametrize("variant,N", [("base", 40), ("exp2", 40), ("allheads", 40),
                                       ("rowtile", 300)])
def test_attn_variants_build_matches_plain(tpu_interpret, monkeypatch, variant, N):
    B, H = 2, 4
    mod = load_tool(monkeypatch, "bench_attn_variants", B=B, N=N, H=H, D=H * 64)
    qkv = _qkv(B, N, H, 2)
    attn, _ = mod.build(variant)
    _check_attention(attn(jnp.asarray(qkv, jnp.bfloat16)), qkv, H,
                     exp2=variant != "base", nomax=False, bf16p=False)


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_pallas_mm_matches_plain(tpu_interpret, monkeypatch, dtype):
    mod = load_tool(monkeypatch, "bench_int8_pallas", BM=64)
    rng = np.random.RandomState(3)
    if dtype == "int8":
        x = rng.randint(-127, 128, (128, 64)).astype(np.int8)
        w = rng.randint(-127, 128, (64, 128)).astype(np.int8)
        want = np.asarray(mod._pallas_mm(jnp.asarray(x), jnp.asarray(w), jnp.int32))
        got = tc_matmul_reference(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want)
    else:
        x = rng.randn(128, 64).astype(np.float32)
        w = (rng.randn(64, 128) * 0.03).astype(np.float32)
        want = np.asarray(mod._pallas_mm(jnp.asarray(x, jnp.bfloat16),
                                         jnp.asarray(w, jnp.bfloat16), jnp.float32))
        got = tc_matmul_reference(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(w).bfloat16()).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("store,math", [("fp32", "fp32"), ("bf16", "bf16"),
                                        ("bf16", "fp32")])
def test_chain_matches_plain(tpu_interpret, monkeypatch, store, math):
    mod = load_tool(monkeypatch, "bench_vpu_bf16", B=2, S=16)
    jt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
    tt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    x = np.random.RandomState(4).rand(2, 16, 16).astype(np.float32)
    want = to_np(mod.chain(jnp.asarray(x, jt[store]), jt[math], 6))
    got = elementwise_chain_reference(torch.from_numpy(x).to(tt[store]), 6, tt[math])
    if math == "bf16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        tol = 6 * 2.0 ** -23 if store == "fp32" else 2.0 ** -8
        assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize("store,math", [("fp32", "fp32"), ("bf16", "bf16"),
                                        ("bf16", "fp32")])
def test_chain_keeps_nan_like_pallas(tpu_interpret, monkeypatch, store, math):
    """NaN, ±inf, -0.5, 1.5 and values at the threshold through the TPU
    script's chain and the plain version: NaN in the same places, the
    other values within the stated tolerance (bit for bit in bf16 math)."""
    mod = load_tool(monkeypatch, "bench_vpu_bf16", B=2, S=16)
    jt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
    tt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    x = bench_vpu_bf16.special_values(torch.float32, n=2 * 16 * 16).view(2, 16, 16)
    want = to_np(mod.chain(jnp.asarray(x.numpy(), jt[store]), jt[math], 6))
    got = elementwise_chain_reference(x.to(tt[store]), 6, tt[math]).float().numpy()
    nan = np.isnan(want)
    assert nan.sum() == 2 and np.array_equal(np.isnan(got), nan)
    if math == "bf16":
        np.testing.assert_array_equal(got[~nan], want[~nan])
    else:
        tol = 6 * 2.0 ** -23 if store == "fp32" else 2.0 ** -8
        assert np.abs(got[~nan] - want[~nan]).max() <= tol


@pytest.mark.parametrize("tool", [bench_ln_matmul, bench_packed_attn,
                                  bench_attn_variants, bench_int8_pallas,
                                  bench_vpu_bf16], ids=lambda m: m.__name__.split(".")[-1])
def test_tool_runs_on_cpu(tool):
    rows = tool.run("cpu", **tool.CPU_SHAPES)
    assert rows and all(r["ok"] for r in rows), rows
    assert all(r["ms"] is None and r["device"] == "cpu" for r in rows)
    assert all(r["bound_ms"] > 0 for r in rows)


def test_tool_main_on_cpu(capsys):
    bench_vpu_bf16.common.main(bench_vpu_bf16.run, "chain", bench_vpu_bf16.CPU_SHAPES,
                               ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "nothing timed" in out and out.count(" ok ") == 3


def _qkv_bf16(B, N, H, dh=64, offset=0):
    """A zero (B, N, 3 H dh) bf16 qkv whose data starts `offset` elements
    into its storage (4: 8 bytes, off the 16-byte alignment TMA needs)."""
    n = B * N * 3 * H * dh
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(B, N, 3 * H * dh)


def _mm(M, K, F, offset=0):
    x = torch.zeros(M * K + offset, dtype=torch.int8)[offset:].view(M, K)
    return x, torch.zeros(K, F, dtype=torch.int8)


VARIANT = dict(exp2=True, nomax=True, bf16p=False)
# case: (the call, what its refusal names)
REFUSALS = {
    "attn misaligned qkv": (lambda: attention.packed_attention_variant(
        _qkv_bf16(2, 5, 2, offset=4), 2, **VARIANT), "16-byte aligned"),
    "attn block_q 128": (lambda: attention.packed_attention_variant(
        _qkv_bf16(2, 5, 2), 2, **VARIANT, block_q=128), "block_q"),
    "attn dh 32": (lambda: attention.packed_attention_variant(
        _qkv_bf16(2, 5, 2, dh=32), 2, **VARIANT), "head width 32"),
    "attn heads_per_block 4 of 6": (lambda: attention.packed_attention_variant(
        _qkv_bf16(2, 5, 6), 6, **VARIANT, heads_per_block=4), "heads_per_block"),
    "mm M 100": (lambda: int8_matmul.tc_matmul(*_mm(100, 64, 128)), "M=100"),
    "mm K 48": (lambda: int8_matmul.tc_matmul(*_mm(128, 48, 128)), "K=48"),
    "mm F 200": (lambda: int8_matmul.tc_matmul(*_mm(128, 64, 200)), "F=200"),
    "mm misaligned x": (lambda: int8_matmul.tc_matmul(*_mm(128, 64, 128, offset=8)),
                        "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_row13_kernels_refuse_before_any_launch(monkeypatch, case):
    """What csrc/packed_attn_variants.cu (bf16, dh 64, block_q 64 or 256,
    heads and images a block that divide, a 16-byte aligned qkv for its TMA
    map) and csrc/int8_gemm.cu (M % 128, K % 32, F % 128, 16-byte aligned
    operands) do not take is refused before any build or launch: the device
    test is forced to say "kernel" on these CPU tensors, and reaching the
    kernel fails the test."""
    def no_launch(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernel")

    for mod in (attention, int8_matmul):
        monkeypatch.setattr(mod, "use_kernel", lambda *args: True)
    monkeypatch.setattr(attention.cuda_build, "kernel_fn", no_launch)
    call, match = REFUSALS[case]
    before = (attention.packed_attention_variant.launches,
              int8_matmul.tc_matmul.launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert before == (attention.packed_attention_variant.launches,
                      int8_matmul.tc_matmul.launches)


def test_bench_eval_on_cpu(capsys):
    """Every mode on a small ragged set (CARL at 32 px): the sweep each mode
    names, one finite embedding a frame, and the embeddings of the flat and
    packed sweeps within the sweeps' tolerance of the per-video ones
    (`tests/test_torch_eval_sweeps.py`: 2e-6)."""
    from video_rep_learning_tpu_torch.tools import bench_eval

    rows = bench_eval.main(["--device", "cpu", "--lengths", "5,9,7"])
    assert [(r["mode"], r["sweep"]) for r in rows] == [
        ("per_video", "per_video"), ("flat", "flat"), ("packed2", "packed"),
        ("packed4", "packed")]
    for r in rows:
        assert r["useful_frames"] == 21 and r["frames_per_s"] > 0
        assert r["max_abs_diff_vs_per_video"] <= 2e-6
    out = capsys.readouterr().out
    assert out.count("carl: ragged") == 4 and '"rows"' in out


def test_bench_host_pipeline_on_cpu(tmp_path, capsys):
    from video_rep_learning_tpu_torch.tools import bench_host_pipeline

    rows = bench_host_pipeline.main(["--data", str(tmp_path / "pouring"), "--epochs", "1",
                                     "--frames", "8", "--workers", "0", "2",
                                     "--size", "32"])
    assert [(r["workers"], r["epoch"]) for r in rows] == [(0, 0), (2, 0)]
    for r in rows:  # two views of 8 frames a clip
        assert r["clips_per_s"] > 0 and r["frames_per_s"] == pytest.approx(16 * r["clips_per_s"])
    assert "workers=2 epoch 0" in capsys.readouterr().out
