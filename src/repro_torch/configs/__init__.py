"""Architecture configs (the port's own copies; see ``registry``)."""
