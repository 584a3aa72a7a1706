"""Model entry points: approximate state preparation (ASP)."""
