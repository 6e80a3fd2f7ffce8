"""User-facing API: synthetic benchmark crowds."""
