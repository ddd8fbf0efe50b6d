"""Frozen copies that the benchmark measures with: the AMQP client and its
codec (the load generator), the router deployment's generator, and the
roofline counts and peaks. They import only from ``mqbench``, never from
the program, so a change to the program cannot move the yardstick."""
