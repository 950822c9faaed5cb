"""The port's CUDA kernels against their plain versions, on the card.

    pytest -m gpu tests/test_torch_gpu.py

Every test here needs a CUDA card and ``nvcc``; without a card each test
skips with that reason (decided inside the ``cuda`` fixture, so every
pytest worker collects the same tests).  Tolerances, relative to the
largest |value| of the plain output: fp32 1e-5 (fp32 sums in another
order); bf16 one bf16 step, 2^-8 (two fp32 sums may round to neighbouring
bf16 values).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import arrayflex_gemm as ag
from repro_torch.models import lm
from repro_torch.serving import Request, ServeConfig, ServingEngine

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dt):
    torch.cuda.synchronize()
    scale = max(want.float().abs().max().item(), 1.0)
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == want.shape and err <= TOL[dt] * scale, (err, scale)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("mkn", [(4, 896, 896), (37, 130, 200),
                                 (300, 896, 4864), (1, 64, 152064 // 64)])
@pytest.mark.parametrize("flags", ["none", "qkv", "swiglu", "residual",
                                   "gelu_bias2", "f32_out"])
def test_arrayflex_gemm_matches_plain(cuda, dt, k, mkn, flags):
    M, K, N = mkn
    g = torch.Generator(device=cuda).manual_seed(M + K + N + k)

    def r(*s, dtype=dt):
        return torch.randn(*s, generator=g, device=cuda).to(dtype)

    x, w = r(M, K), r(K, N)
    kw = {"none": {},
          "qkv": dict(bias=r(N, dtype=torch.float32),
                      norm_scale=r(K, dtype=torch.float32)),
          "swiglu": dict(w2=r(K, N), activation="silu",
                         norm_scale=r(K, dtype=torch.float32)),
          "residual": dict(residual=r(M, N)),
          "gelu_bias2": dict(w2=r(K, N), activation="gelu",
                             bias=r(N, dtype=torch.float32),
                             bias2=r(N, dtype=torch.float32)),
          "f32_out": dict(out_dtype=torch.float32)}[flags]
    before = ag.LAUNCHES["arrayflex_gemm"]
    got = ag.arrayflex_gemm(x, w, k_collapse=k, **kw)
    assert ag.LAUNCHES["arrayflex_gemm"] == before + 1
    _close(got, ag.arrayflex_gemm_plain(x, w, **kw), dt)


@pytest.mark.parametrize("combo", ["f32", "bf16", "f32xbf16"])
@pytest.mark.parametrize("etkn", [(8, 7, 64, 256), (8, 7, 256, 64),
                                  (8, 1792, 64, 256), (3, 5, 130, 70)])
def test_arrayflex_expert_gemm_matches_plain(cuda, combo, etkn):
    E, T, K, N = etkn
    dx, dw = {"f32": (torch.float32, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16),
              "f32xbf16": (torch.float32, torch.bfloat16)}[combo]
    g = torch.Generator(device=cuda).manual_seed(T + K)
    x = torch.randn(E, T, K, generator=g, device=cuda).to(dx)
    w = torch.randn(E, K, N, generator=g, device=cuda).to(dw)
    got = ag.arrayflex_expert_gemm(x, w, k_collapse=2,
                                   out_dtype=torch.float32)
    _close(got, ag.arrayflex_expert_gemm_plain(x, w,
                                               out_dtype=torch.float32),
           torch.float32)


def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ag.arrayflex_gemm(x, x.t().contiguous())
    x = torch.zeros(8, 4, device=cuda).t()            # column-major rows
    with pytest.raises(ValueError, match="unit stride"):
        ag.arrayflex_gemm(x, torch.zeros(8, 4, device=cuda))


def test_engine_launches_every_kernel(cuda):
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              gemm_backend="arrayflex")
    params = lm.init_params(cfg, seed=0)
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_seq=32))
    reqs = [Request(prompt=[5, 6, 7], max_new_tokens=3, rid=0),
            Request(prompt=[9, 10], max_new_tokens=3, rid=1)]
    for r in reqs:
        eng.submit(r)
    ag.reset_launches()
    eng.run_to_completion()
    steps = eng.stats["prefill_dispatches"] + eng.stats["decode_dispatches"]
    L = cfg.n_layers
    assert ag.LAUNCHES == {"arrayflex_gemm": (6 * L + 1) * steps,
                           "arrayflex_expert_gemm": 2 * L * steps}
    assert all(r.done and len(r.out_tokens) == 3 for r in reqs)
