"""Receiver status / metrics state.

Structured-metrics equivalent of `struct tetra_display_state`
(tetra_common.h:268-296): written by the MAC layers, exported to UIs,
metrics pipelines, and the CLI.  `as_dict()` is the stable export surface.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict


@dataclass
class DisplayState:
    curr_hyperframe: int = 0
    curr_multiframe: int = 0
    curr_frame: int = 0
    # 0 other, 1 NORM1(SCH/F or traffic), 2 NORM2, 3 SYNC, 4 traffic
    timeslot_content: list[int] = field(default_factory=lambda: [0, 0, 0, 0])
    dl_usage: int = 0
    ul_usage: int = 0
    access1_code: str = ""
    access2_code: str = ""
    access1: int = 0
    access2: int = 0
    dl_freq: int = 0
    ul_freq: int = 0
    mcc: int = 0
    mnc: int = 0
    cc: int = 0
    last_crc_fail: bool = False
    advanced_link: bool = False
    air_encryption: bool = False
    sndcp_data: bool = False
    circuit_data: bool = False
    voice_service: bool = False
    normal_mode: bool = False
    migration_supported: bool = False
    never_minimum_mode: bool = False
    priority_cell: bool = False
    dereg_mandatory: bool = False
    reg_mandatory: bool = False

    def as_dict(self) -> dict:
        return asdict(self)
