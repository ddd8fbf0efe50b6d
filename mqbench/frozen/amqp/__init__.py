"""A frozen copy of the program's AMQP 0-9-1 wire codec
(``chanamq_tpu_torch/amqp``), which the frozen client speaks."""
