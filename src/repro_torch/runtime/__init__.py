"""Runtimes of the port (counterpart of ``repro/runtime``): the fault
vocabulary (:mod:`.faults`, a copy), the continuous-batching decode
server (:mod:`.server`) and the fault-tolerant trainer (:mod:`.trainer`)."""
