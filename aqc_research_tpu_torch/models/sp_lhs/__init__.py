"""Approximate state preparation (ASP) over Trotter targets."""
