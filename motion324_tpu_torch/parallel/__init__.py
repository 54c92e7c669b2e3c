"""Data, tensor, sequence and pipeline parallelism over ``torch.distributed``
(counterpart of ``motion324_tpu/parallel/``): process-group start-up from
the launcher's environment (:mod:`.distributed`), the ``(dp, mp)`` mesh of
process groups (:mod:`.mesh`), the autograd-aware collectives the models
call (:mod:`.collectives`) and the Megatron column/row sharding of the
transformer weights (:mod:`.tp`), and the GPipe stages of the alternating
stack (:mod:`.pp`)."""
