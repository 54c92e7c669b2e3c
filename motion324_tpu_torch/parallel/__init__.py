"""Data, tensor and sequence parallelism over ``torch.distributed``
(counterpart of ``motion324_tpu/parallel/``): process-group start-up from
the launcher's environment (:mod:`.distributed`), the ``(dp, mp)`` mesh of
process groups (:mod:`.mesh`), the autograd-aware collectives the models
call (:mod:`.collectives`) and the Megatron column/row sharding of the
transformer weights (:mod:`.tp`). Pipeline parallelism is not ported yet
(ROADMAP Queue 1 item 11)."""
