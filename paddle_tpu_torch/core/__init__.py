"""The Program substrate: IR, registry, scope, Executor and backward
(counterpart of ``paddle_tpu/core``)."""
