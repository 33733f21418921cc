"""Runtimes of the port (counterpart of ``repro/runtime``): the fault
vocabulary (:mod:`.faults`, a copy) and the continuous-batching decode
server (:mod:`.server`)."""
