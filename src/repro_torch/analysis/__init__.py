"""Cost analysis of the port's programs: the op-level FLOP, byte and COP
count of a search (:mod:`repro_torch.analysis.op_cost`)."""
