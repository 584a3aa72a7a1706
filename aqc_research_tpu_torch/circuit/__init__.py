"""Circuit IR: ansatz, structures, gates, gate programs."""
