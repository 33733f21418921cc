"""Launchers of the port (counterpart of ``repro/launch``): ported so far,
the serving launcher :mod:`.serve`."""
