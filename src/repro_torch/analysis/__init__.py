"""Cost analysis of the port's programs: the op-level FLOP, byte, COP and
cross-device copy count of any torch program and of a search
(:mod:`repro_torch.analysis.op_cost`), and the dry run's tables
(:mod:`repro_torch.analysis.rooflines`)."""
