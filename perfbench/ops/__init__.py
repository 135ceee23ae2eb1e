"""One module per op the benchmark can check, found by the op's name:
``NUMBER`` (the name of the number compared) and ``LIMIT``,
``program_values(result)`` (the numbers of the program's result) and
``reference_values(n, src, dst, acc)`` (the same numbers from the plain
reference, in the same order)."""
