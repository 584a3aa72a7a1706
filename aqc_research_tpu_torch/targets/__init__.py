"""Trotter evolution targets and the target state / unitary generators."""
