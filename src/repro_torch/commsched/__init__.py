"""PowerTCP as a framework feature: window-controlled, compressed,
chunked cross-pod collectives (twin of ``repro.commsched``; the outer
sync over the ranks of a ``torch.distributed`` group)."""
from .controller import (CONTROLLERS, AIMD, ControllerConfig, HPCCLike,
                         ThetaPowerTCP, WindowController, make_controller)
from .simbackend import DCNConfig, SimResult, rdcn_bw_fn, run_reduction
from .outer import (bucketize, dequantize_int8, make_outer_sync,
                    quantize_int8, window_to_buckets)
from .straggler import StragglerPolicy, simulate_syncs, sync_plan

__all__ = ["CONTROLLERS", "AIMD", "ControllerConfig", "HPCCLike",
           "ThetaPowerTCP", "WindowController", "make_controller",
           "DCNConfig", "SimResult", "rdcn_bw_fn", "run_reduction",
           "bucketize", "dequantize_int8", "make_outer_sync", "quantize_int8",
           "window_to_buckets", "StragglerPolicy", "simulate_syncs",
           "sync_plan"]
