"""PyTorch port parity: the names the ``utils`` package exports.

Each of the JAX package's ``pioran_tpu.utils`` names is importable from
``pioran_tpu_torch.utils``, in the same order, as the port's own
function: ``roots_valid_jit`` becomes ``roots_valid_batch``.
"""

import importlib

import pytest

import pioran_tpu.utils as jutils
import pioran_tpu_torch.utils as tutils

RENAMED = {"roots_valid_jit": "roots_valid_batch"}
HOMES = {"roots": ("check_conjugate_pair", "check_order_imag_roots", "check_roots_bounds",
                   "roots_valid_batch"),
         "subset": ("extract_subset",),
         "samples": ("separate_samples", "makelist_namessplit"),
         "mcmc_stats": ("split_rhat", "ess_bulk", "ess_tail", "summarize_chains")}


def test_utils_exports_the_jax_names_in_order():
    assert [RENAMED.get(n, n) for n in jutils.__all__] == tutils.__all__


@pytest.mark.parametrize("module", sorted(HOMES))
def test_utils_names_are_the_ports_functions(module):
    mod = importlib.import_module(f"pioran_tpu_torch.utils.{module}")
    for name in HOMES[module]:
        assert getattr(tutils, name) is getattr(mod, name)
        jname = {v: k for k, v in RENAMED.items()}.get(name, name)
        assert callable(getattr(jutils, jname))
