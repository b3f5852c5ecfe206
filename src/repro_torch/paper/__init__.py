"""The paper's tables and figures on the port's analytic model: one module
per runner of the reference's ``benchmarks/`` (and ``examples/
stco_sweep.py``), each printing the reference's rows.

Run: python -m repro_torch.paper.run [--only table1,fig1]"""
