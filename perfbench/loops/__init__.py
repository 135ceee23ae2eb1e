"""The traffic drivers, one module per ``loop`` that a traffic file
names, found by that name: ``run(inputs, traffic, *, seed, seconds,
trace, device, t_start)`` does the set-up (plans, a cold run, a warm run
of every shape the window uses), runs the measured window and returns
the run's record: the window's numbers, the answers for the check and,
with tracing, the traced window."""
