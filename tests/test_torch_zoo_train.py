"""Training the model zoo in the port: MKOR + LAMB steps against the JAX
package's jitted step on rwkv6-3b (first-order recurrence vectors beside
MKOR layers), at tests/test_torch_zoo_check.py's tolerances.  whisper-base's
steps are in tests/test_torch_zoo.py, the launcher in
tests/test_torch_zoo_launch.py (the files are split to stay under a
minute each)."""
import pytest
import torch

import test_torch_zoo_check as zoo

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["rwkv6-3b"])
def test_mkor_steps_match(name):
    zoo.zoo_mkor_steps(name)
