"""The port's DTensor steps repeat no product over 'model'
(`launch/dryrun.py:replication`): every arch's reduced config on a fake
(data=2, model=4) mesh in the 2D mode, at global batch 2 (one sequence
a data rank), counted on the first device's shards against the same step
counted once on global tensors. A ratio of 4 is the whole step repeated
on every 'model' rank; the bound is 1.10, or the JAX package's own ratio
where that is higher (`REFERENCE_RATIOS`, the recurrent archs, whose
scans XLA counts as FLOPs; tests/test_torch_tp_layout_ref.py holds the
bound to the reference for three archs). train_4k for every arch here,
prefill_32k for the five dense attention archs in
tests/test_torch_tp_layout_prefill.py, each in a child process on the
fake group."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import all_archs
from repro_torch.launch import dryrun
from repro_torch.models import layers as L
from repro_torch.models import tp as T

from _torch_plans import TP_CHILD, check_ratio, run_child


@pytest.fixture(scope="module")
def train():
    return run_child(TP_CHILD % ("train_4k", list(all_archs())), timeout=300)


@pytest.mark.parametrize("arch_id", list(all_archs()))
def test_train_step_repeats_no_product_over_model(train, arch_id):
    check_ratio(train[arch_id], arch_id, "train_4k")


def test_reference_ratios_bound_only_the_recurrent_archs():
    assert {a for a, _ in dryrun.REFERENCE_RATIOS} == {
        "recurrentgemma-2b", "rwkv6-1.6b"}
    assert all(v > dryrun.TP_RATIO_BOUND
               for v in dryrun.REFERENCE_RATIOS.values())
    assert dryrun.TP_MESH == (2, 4)


@pytest.mark.parametrize("t", [4096, 32768])
@pytest.mark.parametrize("arch_id,size,ways", [
    ("recurrentgemma-2b", "config", 16), ("recurrentgemma-2b", "reduced", 4),
    ("llava-next-34b", "config", 16), ("granite-moe-3b-a800m", "config", 16)])
def test_the_counted_rank_attends_as_a_busiest_rank(arch_id, size, ways, t):
    """The dry run counts the query-sequence split at the last 'model'
    rank (`tp.as_last_rank`): its two blocks' attention costs the most of
    any rank's, with recurrentgemma-2b's local window (where the first
    rank's block 0 skips more KV chunks) and with plain causal attention,
    at the train and prefill lengths and the ways of the production and
    the test meshes."""
    cfg = getattr(all_archs()[arch_id], size)
    assert cfg.n_heads % ways                  # the query-sequence split
    windowed = any(k in ("attn_local", "rglru_attn")
                   for g in cfg.groups for k in g.unit)
    assert windowed == (arch_id == "recurrentgemma-2b")

    def flops(rank):
        c, starts = T.Region(None, (), (), ways, rank, 1).blocks(t)
        q = torch.empty(1, c, 1, 8, device="meta")
        k = torch.empty(1, t, 1, 8, device="meta")
        with FlopCounterMode(display=False) as fc:
            for s in starts:
                L.flash_attention(q, k, k, causal=True,
                                  window=cfg.window if windowed else None,
                                  scale=1.0, cap=None, q_offset=s)
        return fc.get_total_flops()

    per_rank = [flops(r) for r in range(ways)]
    assert per_rank[-1] == max(per_rank) > 0
    if windowed and (size, t) != ("config", 4096):
        assert per_rank[0] < per_rank[-1]
