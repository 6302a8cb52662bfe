"""The benchmark's yardsticks: the useful FLOPs of a heatmap against a count
by hand, the frozen kernel work against the port's, and the traffic plan."""

import numpy as np
import pytest
from tiny import TINY

from bench_port.harness import flash_work, spec
from bench_port.traffic import closed_batches


def _config(family):
    cell = spec.Cell({"mistral": "mistral-7b-v0.3.batch-mixed",
                      "mixtral": "mixtral-8x7b-nf4.docs-4k"}[family])
    config = dict(cell.config, config=dict(cell.config["config"], **TINY))
    return cell.family, config


def test_flops_of_a_tiny_mistral_by_hand():
    family, config = _config("mistral")
    # D 64, I 96, L 2, H 4, Hkv 2, hd 16, V 128; a prompt of 10 tokens
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64           # q, k, v, o
    mlp = 3 * 64 * 96                                # gate, up, down
    linear = 4 * (attn + mlp) * 10 * 2               # forward + dx, 2 layers
    attention = 3.5 * 4 * 4 * 16 * 55 * 2            # 55 causal pairs
    head = 4 * 64 * 128
    assert family.heatmap_flops(config, 10) == linear + attention + head


def test_flops_of_a_tiny_mixtral_by_hand():
    family, config = _config("mixtral")
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    moe = 64 * 8 + 2 * 3 * 64 * 96                   # router + top-2 experts
    linear = 4 * (attn + moe) * 10 * 2
    attention = 3.5 * 4 * 4 * 16 * 55 * 2
    head = 4 * 64 * 128
    assert family.heatmap_flops(config, 10) == linear + attention + head


@pytest.mark.parametrize("args,kw", [
    (("flash_fwd", 8, 32, 8, 1024, 128), dict(kv_begin=[0, 100, 500, 1000, 3, 5, 7, 9])),
    (("flash_bwd_dq", 1, 32, 8, 4096, 128), dict(dlse=True, q_start=1024, Tk=2048)),
    (("flash_bwd_dkv", 2, 16, 16, 512, 64), dict(window=100, kv_end=[300, 512])),
])
def test_frozen_work_equals_the_ports(args, kw):
    from lxt_tpu_torch.ops import flash_attention
    assert flash_work.work(*args, **kw) == flash_attention.work(*args, **kw)


def test_the_plan_is_the_same_work_for_every_seed():
    cell = spec.Cell("mistral-7b-v0.3.batch-mixed")
    lengths = closed_batches.lengths(cell.spec["traffic"])
    assert len(lengths) == 16 and all(len(c) == 8 for c in lengths)
    flat = np.array(lengths).ravel()
    assert flat.min() >= 64 and flat.max() <= 2048
    a = closed_batches.plan(cell.spec["traffic"], 32768, 2**31 + 11)
    b = closed_batches.plan(cell.spec["traffic"], 32768, 7)
    assert [[len(p) for p in c] for c in a] == lengths == [[len(p) for p in c] for c in b]
    assert not all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    again = closed_batches.plan(cell.spec["traffic"], 32768, 2**31 + 11)
    assert all(np.array_equal(x, y) for ca, cb in zip(a, again) for x, y in zip(ca, cb))
    assert all(p.max() < 32768 and p.min() >= 0 for c in a for p in c)


def test_the_closed_loop_counts_the_call_that_crosses_the_window():
    ticks = iter(range(100))
    records, window = closed_batches.drive(
        lambda prompts: len(prompts), [[1], [1, 2]], 5, clock=lambda: next(ticks))
    assert window >= 5 and records[-1]["end"] == window
    assert [r["index"] for r in records] == [0, 1, 0]
