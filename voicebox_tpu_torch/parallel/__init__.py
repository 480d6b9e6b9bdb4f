"""Parallel training across processes: the process-group bootstrap
(`distributed`), the device mesh (`mesh`), the parameter placement rules
(`sharding_rules`), the collectives and their transposes (`collectives`),
tensor parallelism (`tensor_parallel`), sequence parallelism
(`sequence_parallel`), pipeline parallelism (`pipeline`: the V-cycle over a
"pipe" group, `make_pp_forward`) and the layouts the trainers run under
(`data_parallel`)."""

from .pipeline import make_pp_forward, mirror_back_rows

__all__ = ["make_pp_forward", "mirror_back_rows"]
