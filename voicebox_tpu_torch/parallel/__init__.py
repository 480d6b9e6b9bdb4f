"""Data-parallel training across processes: the process-group bootstrap
(`distributed`), the ("data", "model") device mesh (`mesh`), the parameter
placement rules (`sharding_rules`) and the replicated and FSDP layouts the
trainers run under (`data_parallel`). Model-parallel layouts (tensor and
sequence parallelism, the pipeline) wait for ROADMAP item 15b."""
