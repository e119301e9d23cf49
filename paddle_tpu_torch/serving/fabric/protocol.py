"""Length-prefixed JSON wire protocol for the serving fabric (counterpart
of paddle_tpu/serving/fabric/protocol.py, copied whole: the same bytes on
the wire).

Frame layout (identical skeleton to the PS wire: 8-byte big-endian
length, then payload) with a JSON payload instead of the PS binary
codec:

    +----------------+----------------------+
    | len (8B, >Q)   | utf-8 JSON object    |
    +----------------+----------------------+

JSON over the PS frame is a deliberate trade: fabric messages are
small control records (op, prompt token ids, sampled tokens) where
schema evolution and debuggability beat the binary codec's density —
and bulk bytes (model artifacts) ride base64-chunked fetches, not one
giant frame. The codec plugs into ResilientChannel via its `codec=`
pair, so retries, breakers, deadlines and `_trace` span continuation
are inherited, not reimplemented.

Failure taxonomy (all defined in distributed/resilience.py so the
channel can classify them without importing serving):

- FrameTooLargeError  declared length exceeds MAX_FRAME — refused
                      BEFORE allocating, so a corrupted header cannot
                      OOM the receiver. Not retryable.
- FrameDecodeError    payload arrived whole but is not valid JSON (or
                      not JSON-encodable on send). Not retryable.
- ConnectionError     peer closed mid-frame — the standard transport
                      loss the channel reconnects/retries on.
"""
import json
import struct

from ...distributed.resilience import FrameDecodeError, FrameTooLargeError

__all__ = ['MAX_FRAME', 'JSON_CODEC', 'encode', 'decode', 'send_frame',
           'recv_frame', 'FrameDecodeError', 'FrameTooLargeError']

# Generous for control traffic (a 4k-token prompt is ~30KB of JSON) yet
# small enough that a corrupted length header fails fast. Artifact
# fetches chunk well below this (artifacts.CHUNK).
MAX_FRAME = 16 << 20


def encode(obj):
    """Object -> utf-8 JSON bytes. Raises FrameDecodeError on
    non-JSON-encodable input so the caller sees a typed protocol error,
    not a bare TypeError from deep inside the channel."""
    try:
        return json.dumps(obj, separators=(',', ':')).encode('utf-8')
    except (TypeError, ValueError) as e:
        raise FrameDecodeError('message is not JSON-encodable: %s' % e)


def decode(buf):
    """utf-8 JSON bytes -> object, FrameDecodeError on garbage."""
    try:
        return json.loads(buf.decode('utf-8'))
    except (UnicodeDecodeError, ValueError) as e:
        raise FrameDecodeError('frame payload is not valid JSON: %s' % e)


# the (encode, decode) pair ResilientChannel(codec=...) expects
JSON_CODEC = (encode, decode)


def send_frame(sock, obj, max_frame=MAX_FRAME):
    """Server-side helper: frame and send one JSON message."""
    payload = encode(obj)
    if len(payload) > max_frame:
        raise FrameTooLargeError(
            'refusing to send %d-byte frame (max_frame=%d)'
            % (len(payload), max_frame))
    sock.sendall(struct.pack('>Q', len(payload)) + payload)


def recv_frame(sock, max_frame=MAX_FRAME):
    """Server-side helper: receive one framed JSON message.

    Returns None on a clean EOF at a frame boundary (client hung up
    between requests — the normal end of a connection); raises
    ConnectionError on EOF MID-frame (the bytes the peer promised never
    arrived), FrameTooLargeError / FrameDecodeError per the taxonomy.
    """
    hdr = b''
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            if not hdr:
                return None
            raise ConnectionError('peer closed mid-header')
        hdr += chunk
    n = struct.unpack('>Q', hdr)[0]
    if n > max_frame:
        raise FrameTooLargeError(
            'peer declared %d-byte frame (max_frame=%d)' % (n, max_frame))
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError('peer closed mid-frame')
        buf.extend(chunk)
    return decode(bytes(buf))
