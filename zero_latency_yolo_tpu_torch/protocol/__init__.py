"""ZLTY wire protocol — byte-compatible with the reference C++ implementation.

The reference serializes packets as a packed 22-byte header followed by a
type-specific body (reference: src/common/protocol.h:37-73). Struct bodies
CLIENT_INFO / SERVER_INFO / DETECTION_RESULT are raw memcpys of C structs
*with natural alignment padding* (reference: src/common/protocol.h:337-358,
:541-567; layouts src/common/types.h:20-56), which this module reproduces
exactly.
"""

from .packets import (  # noqa: F401
    HEADER_SIZE,
    MAGIC,
    VERSION,
    MAX_PACKET_SIZE,
    PacketType,
    ErrorCode,
    CommandType,
    PacketHeader,
    Detection,
    ClientInfo,
    ServerInfo,
    HeartbeatPacket,
    ClientInfoPacket,
    ServerInfoPacket,
    FrameDataPacket,
    DetectionResultPacket,
    ErrorPacket,
    CommandPacket,
    ConfigUpdatePacket,
    AckPacket,
    ProtocolError,
    crc16,
    parse_packet,
    parse_header,
)
from .roi import ROI_HEADER_SIZE, RoiHeader, parse_roi_header, build_roi_header  # noqa: F401
