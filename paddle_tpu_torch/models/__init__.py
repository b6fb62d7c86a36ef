"""Model builders."""
from . import transformer  # noqa: F401
