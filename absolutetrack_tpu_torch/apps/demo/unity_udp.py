"""Unity over UDP (port of ``absolutetrack_tpu/apps/demo/unity_udp.py``,
reference demo/ume_tracker.py:206-223).

Packet: ``"U;{hand0};{hand1}"``, each hand the Python ``str`` of its
int-flattened (21, 3) keypoints after the reference's axis flips (y
negated; x negated twice, so unchanged).
"""

from __future__ import annotations

import socket
from typing import Dict

import numpy as np

DEFAULT_ADDR = ("127.0.0.1", 5052)


def encode_packet(keypoints: Dict[int, np.ndarray]) -> bytes:
    """The packet of both hands; the caller supplies hands 0 and 1."""
    content = ["U"]
    for hand_idx in keypoints:
        data = np.asarray(keypoints[hand_idx]).copy()
        data[:, :2] *= -1
        data[:, 0] *= -1  # FLIP_X: the net effect negates y only
        content.append(str(data.flatten().astype(int).tolist()))
    return ";".join(content).encode()


class UnitySender:
    def __init__(self, addr=DEFAULT_ADDR):
        self.addr = addr
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, keypoints: Dict[int, np.ndarray]) -> bool:
        """Send when both hands are present (the reference's gate); True
        when a packet went out."""
        if 0 in keypoints and 1 in keypoints:
            self.sock.sendto(encode_packet(keypoints), self.addr)
            return True
        return False

    def close(self):
        self.sock.close()
