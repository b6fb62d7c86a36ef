"""Core runtime pieces: dtypes, places, scopes, flags, the op registry
and block lowering."""
