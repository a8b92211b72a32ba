"""The five dense attention archs' reduced prefill_32k on the fake
(data=2, model=4) mesh at global batch 2: no product repeated over
'model' (`launch/dryrun.py:replication`), as tests/test_torch_tp_layout.py
holds every arch's train_4k (split from it for time)."""
import pytest

from _torch_plans import TP_CHILD, check_ratio, run_child

DENSE = ["granite-34b", "command-r-35b", "llama3-405b", "gemma2-27b",
         "llava-next-34b"]


@pytest.fixture(scope="module")
def prefill():
    return run_child(TP_CHILD % ("prefill_32k", DENSE), timeout=300)


@pytest.mark.parametrize("arch_id", DENSE)
def test_prefill_repeats_no_product_over_model(prefill, arch_id):
    check_ratio(prefill[arch_id], arch_id, "prefill_32k")
