"""Per-type repos, the repo manager and the database router."""
