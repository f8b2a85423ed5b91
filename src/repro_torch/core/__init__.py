"""Optimizers: first-order backends, schedules, stat plumbing and MKOR."""
