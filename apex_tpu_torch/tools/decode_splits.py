"""Sweep K6's split size on the card.

K6 (``csrc/paged_decode.cu``) spreads each sequence's page table over
CTAs of at least ``SPLIT_MIN_TOKENS`` tokens (``ops/paged_attention.py``
``decode_split_plan``).  This script times it at ``chip_smoke.py``'s
decode batch (B 8, H 16, D 64, page 16, NP 128, bf16 pages, the fused
RoPE) for splits of 32 to 2048 tokens, at three sets of lengths: the
batch's mixed ones, every slot idle (what the launch costs with no work)
and every slot full (2048 tokens).  Each setting is first checked against
the plain version, then timed with CUDA events around runs queued behind
a spin kernel, L2 flushed before each::

    python -m apex_tpu_torch.tools.decode_splits

It needs a CUDA device and ``nvcc``; it prints the card's name and power
limit and one JSON line per (lengths, split size).
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from apex_tpu_torch.models import rope_cos_sin
from apex_tpu_torch.ops import paged_attention as pa

B, H, D, PAGE, NP, POOL = 8, 16, 64, 16, 128, 1025
LENGTHS = {
    "mixed": [0, 1, 17, 2048, 100, 555, 1024, 2047],
    "idle": [0] * B,
    "full": [2048] * B,
}
SPLIT_TOKENS = (32, 64, 128, 256, 512, 2048)
#: chip_smoke.py's K6_TOL
TOL = dict(atol=4e-3, rtol=8e-3)


def _inputs(lengths, gen):
    dev = "cuda"
    q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k_pages, v_pages = (
        torch.randn(POOL, H, PAGE, D, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
    perm = torch.randperm(POOL - 1, generator=gen, device=dev)[: B * NP] + 1
    table = perm.reshape(B, NP).to(torch.int32).contiguous()
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    cos, sin = rope_cos_sin(NP * PAGE, D, device=dev)
    pos = (lengths.long() - 1).clamp_min(0)
    return ((q, k_pages, v_pages, table, lengths),
            dict(scale=D ** -0.5, rope_cos=cos[pos], rope_sin=sin[pos]))


def _time_ms(fn, flush, iters=25):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # clock cycles: ~0.2 s at ~2 GHz
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("decode_splits needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(),
        flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    default = pa.SPLIT_MIN_TOKENS
    try:
        for tag, lengths in LENGTHS.items():
            args, kw = _inputs(lengths, gen)
            ref = pa.paged_decode_attention_reference(*args, **kw).float()
            for tokens in SPLIT_TOKENS:
                pa.SPLIT_MIN_TOKENS = tokens
                out = pa.paged_decode_fwd(*args, **kw).float()
                if not torch.allclose(out, ref, **TOL):
                    raise AssertionError(
                        f"K6 at {tag} lengths, {tokens}-token splits, "
                        f"disagrees with its plain version")
                ms = _time_ms(lambda: pa.paged_decode_fwd(*args, **kw),
                              flush)
                print(json.dumps({
                    "lengths": tag, "split_tokens": tokens,
                    "plan": pa.decode_split_plan(B, H, NP, PAGE, sms),
                    "default": tokens == default, "ms": ms}), flush=True)
    finally:
        pa.SPLIT_MIN_TOKENS = default


if __name__ == "__main__":
    main()
