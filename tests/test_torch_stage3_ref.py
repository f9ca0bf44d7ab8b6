"""The port's ``-stage 3 -norr -ref`` against the JAX package's, on the CPU:
reference transcripts added to the fragment graph, every output file
byte-identical, ``report.json`` equal but for ``elapsed_s`` (the set-up
and the other options are ``tests/test_torch_stage3_options.py``).
"""

import pytest
import torch

from test_torch_stage3_options import check_case, inputs  # noqa: F401  (the module fixture)
import jax_compile_cache  # noqa: F401  (one JAX compilation cache for the run)

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["ref"])
def test_stage3_options_byte_identical(inputs, tmp_path, case):  # noqa: F811
    check_case(inputs, tmp_path, case)
