"""Command-line tools: ``python -m spsparse_torch.tools <cmd> ...`` and the
API reference generator ``python -m spsparse_torch.tools.apidoc``."""
