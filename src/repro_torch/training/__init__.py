"""The train step (loss, gradients, stat plumbing, optimizer glue), the
chunk runner, chaos, resilience, and serving (prefill and decode)."""
