"""The train step: loss, gradients, stat plumbing, optimizer glue."""
