"""Model builders of the port (the GPT-2 decoder-only LM: transformer.py)."""

from . import transformer  # noqa: F401
