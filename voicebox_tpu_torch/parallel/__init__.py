"""Parallel training across processes: the process-group bootstrap
(`distributed`), the device mesh (`mesh`), the parameter placement rules
(`sharding_rules`), the collectives and their transposes (`collectives`),
tensor parallelism (`tensor_parallel`), sequence parallelism
(`sequence_parallel`) and the layouts the trainers run under
(`data_parallel`). The pipeline waits for ROADMAP Queue 1."""
