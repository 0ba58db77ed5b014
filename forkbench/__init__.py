"""forkbench: the end-to-end benchmark of ``repro_torch`` (cold start by
remote fork, and warm invocations) driven through
``Coordinator.invoke``.  ``python3 forkbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once."""
