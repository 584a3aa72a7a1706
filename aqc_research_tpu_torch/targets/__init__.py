"""Trotter evolution targets."""
