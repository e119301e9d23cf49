"""Cross-process serving fabric: replica transport, worker processes
(counterpart of paddle_tpu/serving/fabric/).

The gateway (serving/gateway/) was built against a duck-typed replica
contract — submit/step/drain/mark_dead/readyz/metrics — that only one
class implemented: InprocReplica, an engine in the same process. This
package makes the contract explicit and gives it a second
implementation that crosses a real process boundary:

- transport.py   ReplicaTransport: the extracted lifecycle + driver
                 base (READY -> DRAINING -> STOPPED | DEAD, condvar
                 drive loop). InprocReplica subclasses it.
- protocol.py    Length-prefixed JSON wire codec with typed frame
                 errors; plugs into ResilientChannel as a codec.
- worker.py      ReplicaWorker: a spawnable process hosting one engine
                 (or ModelHost) behind the wire protocol, with
                 OP_SEMANTICS retry safety, /readyz + /metrics, and
                 (client_id, seq) submit dedup; `python -m
                 paddle_tpu_torch.serving.fabric.worker` runs one
                 (on the card unless --device cpu).
- socket_replica.py  SocketReplica: the gateway-side proxy. Failover,
                 QoS shedding and rollout() work unchanged.
- artifacts.py   Content-fingerprinted model artifact distribution:
                 workers pull checkpoints over the transport and
                 CRC-verify the manifest on receipt.
- directory.py   PrefixDirectory + PrefixAffinityRouter: gateway-level
                 chain-hash directory so routing prefers the replica
                 already holding a request's prefix pages.
- presets.py     Named predictor-zoo presets: `ReplicaWorker --preset
                 gpt-nano` brings up a known config with seeded
                 weights, no hand-built state dicts.
"""
from .artifacts import ArtifactClient, ArtifactServer, ArtifactVerifyError
from .directory import PrefixAffinityRouter, PrefixDirectory
from .presets import PRESETS, build_engine, preset, publish_preset
from .protocol import (JSON_CODEC, MAX_FRAME, FrameDecodeError,
                       FrameTooLargeError, recv_frame, send_frame)
from .socket_replica import SocketReplica
from .transport import (DEAD, DRAINING, READY, STATE_CODES, STOPPED,
                        ReplicaTransport)
from .worker import ReplicaWorker, spawn_worker

__all__ = ['ReplicaTransport', 'SocketReplica', 'ReplicaWorker',
           'spawn_worker', 'ArtifactServer', 'ArtifactClient',
           'ArtifactVerifyError', 'PrefixDirectory',
           'PrefixAffinityRouter', 'PRESETS', 'preset', 'build_engine',
           'publish_preset', 'JSON_CODEC', 'MAX_FRAME', 'send_frame',
           'recv_frame', 'FrameDecodeError', 'FrameTooLargeError',
           'READY', 'DRAINING', 'DEAD', 'STOPPED', 'STATE_CODES']
