"""Frozen copies of the port's plain code (commit e13ae2fbc8b3): the
benchmark's reference and yardstick.  Nothing here imports the port."""
