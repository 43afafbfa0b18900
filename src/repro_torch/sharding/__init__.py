"""Sharding rules: logical axes -> mesh axes, as plain tuples (`specs`)."""
