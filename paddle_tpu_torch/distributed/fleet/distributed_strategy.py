"""DistributedStrategy (counterpart of
paddle_tpu/distributed/fleet/distributed_strategy.py, the same code;
reference: fleet/base/distributed_strategy.py:105 backed by
framework/distributed_strategy.proto:159).

Typed python config (SURVEY.md §5.6 mapping: one config system instead of
protobuf+gflags). Field names match the reference so fleet user code ports
verbatim; each field maps to a sharding/compile decision in strategy.py.
"""
import copy

__all__ = ['DistributedStrategy']


class _Cfg(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        # collective strategies (proto field parity)
        self.amp = False
        self.amp_configs = _Cfg(init_loss_scaling=65536.0, use_pure_fp16=False,
                                use_bf16=True, custom_white_list=[],
                                custom_black_list=[])
        self.recompute = False
        self.recompute_configs = _Cfg(checkpoints=[])
        self.gradient_merge = False
        self.gradient_merge_configs = _Cfg(k_steps=1, avg=True)
        self.sharding = False
        self.sharding_configs = _Cfg(stage=1, sharding_degree=1,
                                     segment_broadcast_MB=32,
                                     hybrid_dp=False, offload=False)
        self.pipeline = False
        self.pipeline_configs = _Cfg(accumulate_steps=1, micro_batch_size=1,
                                     schedule_mode='1F1B')
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Cfg(tensor_parallel_degree=1)
        self.sequence_parallel = False
        self.sequence_parallel_configs = _Cfg(sequence_parallel_degree=1,
                                              mode='ring')
        self.hybrid_configs = _Cfg(dp_degree=-1, mp_degree=1, pp_degree=1,
                                   sharding_degree=1, sp_degree=1,
                                   ep_degree=1)
        self.lamb = False
        self.lamb_configs = _Cfg(lamb_weight_decay=0.01)
        self.lars = False
        self.lars_configs = _Cfg(lars_coeff=0.001, lars_weight_decay=0.0005)
        self.dgc = False
        self.dgc_configs = _Cfg(rampup_begin_step=0, rampup_step=1,
                                sparsity=0.999, momentum=0.9)
        self.localsgd = False
        self.localsgd_configs = _Cfg(k_steps=1)
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = _Cfg(init_k_steps=1,
                                              begin_step=1)
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = True
        self.sync_batch_norm = False
        self.fuse_all_reduce_ops = True
        self.gradient_scale_configs = _Cfg(scale_strategy='avg')
        # parameter-server strategies
        self.a_sync = False
        self.a_sync_configs = _Cfg(k_steps=0, max_merge_var_num=1,
                                   send_queue_size=16, independent_recv_thread=False,
                                   thread_pool_size=1, send_wait_times=1,
                                   runtime_split_send_recv=False, launch_barrier=True,
                                   heter_worker_device_guard='cpu')
        self.auto = False
        self.elastic = False
        # execution/build strategy passthrough
        self.build_strategy = None
        self.execution_strategy = None

    def to_dict(self):
        return {k: copy.deepcopy(v) for k, v in self.__dict__.items()}

    def __repr__(self):
        on = [k for k, v in self.__dict__.items()
              if isinstance(v, bool) and v]
        return 'DistributedStrategy(enabled=%s)' % on

    # strategy.py consumption helper
    def _zero_stage(self):
        if self.sharding:
            return int(self.sharding_configs.get('stage', 1))
        return 0
