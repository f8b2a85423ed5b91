"""Batched serving with the PyTorch port: prefill a prompt batch, then
stream greedy decode steps from ring-buffer / recurrent caches.

    PYTHONPATH=src python examples/torch_serve_batch.py [--arch rwkv6-3b] \\
        [--device cpu]

The counterpart of ``examples/serve_batch.py`` on ``repro_torch``: rwkv6 /
jamba carry O(1) recurrent state, sliding-window archs (mixtral, gemma2's
local layers) carry window-bounded rings, and each decode step updates the
cache in place with the greedy token kept on the device.  Runs the
``.reduced()`` config through ``repro_torch.launch.serve`` (which prints
the cache bytes, the prefill time and tokens/s), on the GPU unless
``--device cpu`` is given; any of the launcher's flags may follow.
"""
import sys

from repro_torch.launch import serve

DEFAULTS = ["--reduced", "--arch", "rwkv6-3b", "--batch", "4",
            "--prompt-len", "48", "--n-tokens", "24"]


if __name__ == "__main__":
    serve.main(DEFAULTS + sys.argv[1:])
