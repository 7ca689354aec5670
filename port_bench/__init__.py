"""The benchmark of tpu_bench_torch, the PyTorch and CUDA port.

One command runs one cell of BENCHMARK.json once:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, column path,
operation or metric sits in a file of its own, found by the name that
BENCHMARK.json gives it (spec.py):

    configs/<config>.json      a deployment: operation, orders, elements, dtype
    traffic/<traffic>.json     the column path the traffic drives
    paths/<path>.py            a column: its label, operand layout, output rows
    operations/<op>.py         the yardstick: seeded inputs, plain reference,
                               control, DOF count, least bytes and FLOP
    programs/<op>.py           how the port binds an operation's columns
    metrics/<metric>.py        the reader of one metric

Nothing here imports jax or the JAX package.
"""
