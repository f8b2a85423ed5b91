"""Model code: configs, layers (dense with MKOR stat capture), attention,
and the stacked-layer model assembly."""
