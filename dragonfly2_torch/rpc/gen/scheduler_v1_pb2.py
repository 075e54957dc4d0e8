# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: scheduler_v1.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


# common.proto is registered through the port's own loader, never a flat
# import that could resolve to another package's copy
from dragonfly2_torch.rpc import protos as _protos  # noqa: E402

common__pb2 = _protos.load("common_pb2")


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12scheduler_v1.proto\x12\x1b\x64ragonfly2_tpu.scheduler.v1\x1a\x0c\x63ommon.proto\"D\n\x13\x41nnounceHostRequest\x12-\n\x04host\x18\x01 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\"\x15\n\x13ProbeStartedRequest\"E\n\x0bProbeResult\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x0e\n\x06rtt_ns\x18\x02 \x01(\x03\x12\x15\n\rcreated_at_ns\x18\x03 \x01(\x03\"P\n\x14ProbeFinishedRequest\x12\x38\n\x06probes\x18\x01 \x03(\x0b\x32(.dragonfly2_tpu.scheduler.v1.ProbeResult\"9\n\x11\x46\x61iledProbeResult\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\"T\n\x12ProbeFailedRequest\x12>\n\x06probes\x18\x01 \x03(\x0b\x32..dragonfly2_tpu.scheduler.v1.FailedProbeResult\"\xae\x02\n\x11SyncProbesRequest\x12-\n\x04host\x18\x01 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\x12I\n\rprobe_started\x18\n \x01(\x0b\x32\x30.dragonfly2_tpu.scheduler.v1.ProbeStartedRequestH\x00\x12K\n\x0eprobe_finished\x18\x0b \x01(\x0b\x32\x31.dragonfly2_tpu.scheduler.v1.ProbeFinishedRequestH\x00\x12G\n\x0cprobe_failed\x18\x0c \x01(\x0b\x32/.dragonfly2_tpu.scheduler.v1.ProbeFailedRequestH\x00\x42\t\n\x07request\":\n\tProbeHost\x12-\n\x04host\x18\x01 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\"K\n\x12SyncProbesResponse\x12\x35\n\x05hosts\x18\x01 \x03(\x0b\x32&.dragonfly2_tpu.scheduler.v1.ProbeHost\"\x07\n\x05\x45mpty\"x\n\x08PeerHost\x12\n\n\x02id\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x10\n\x08rpc_port\x18\x03 \x01(\x05\x12\x11\n\tdown_port\x18\x04 \x01(\x05\x12\x10\n\x08hostname\x18\x05 \x01(\t\x12\x10\n\x08location\x18\x06 \x01(\t\x12\x0b\n\x03idc\x18\x07 \x01(\t\"\x93\x02\n\x0fPeerTaskRequest\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x30\n\x08url_meta\x18\x02 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x0f\n\x07peer_id\x18\x03 \x01(\t\x12\x38\n\tpeer_host\x18\x04 \x01(\x0b\x32%.dragonfly2_tpu.scheduler.v1.PeerHost\x12\x14\n\x0cis_migrating\x18\x05 \x01(\x08\x12\x0f\n\x07task_id\x18\x06 \x01(\t\x12\x32\n\ttask_type\x18\x07 \x01(\x0e\x32\x1f.dragonfly2_tpu.common.TaskType\x12\x1b\n\x13need_back_to_source\x18\x08 \x01(\x08\"{\n\x0bSinglePiece\x12\x0f\n\x07\x64st_pid\x18\x01 \x01(\t\x12\x0e\n\x06\x64st_ip\x18\x02 \x01(\t\x12\x15\n\rdst_down_port\x18\x03 \x01(\x05\x12\x34\n\npiece_info\x18\x04 \x01(\x0b\x32 .dragonfly2_tpu.common.PieceInfo\"\xf6\x01\n\x0eRegisterResult\x12\x32\n\ttask_type\x18\x01 \x01(\x0e\x32\x1f.dragonfly2_tpu.common.TaskType\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12\x34\n\nsize_scope\x18\x03 \x01(\x0e\x32 .dragonfly2_tpu.common.SizeScope\x12@\n\x0csingle_piece\x18\x04 \x01(\x0b\x32(.dragonfly2_tpu.scheduler.v1.SinglePieceH\x00\x12\x17\n\rpiece_content\x18\x05 \x01(\x0cH\x00\x42\x0e\n\x0c\x64irect_piece\"\xd0\x01\n\x0bPieceResult\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07src_pid\x18\x02 \x01(\t\x12\x0f\n\x07\x64st_pid\x18\x03 \x01(\t\x12\x34\n\npiece_info\x18\x04 \x01(\x0b\x32 .dragonfly2_tpu.common.PieceInfo\x12\x0f\n\x07success\x18\x05 \x01(\x08\x12/\n\x04\x63ode\x18\x06 \x01(\x0e\x32!.dragonfly2_tpu.scheduler.v1.Code\x12\x16\n\x0e\x66inished_count\x18\x07 \x01(\x05\"L\n\x08\x44\x65stPeer\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x10\n\x08rpc_port\x18\x03 \x01(\x05\x12\x11\n\tdown_port\x18\x04 \x01(\x05\"\xc9\x02\n\nPeerPacket\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07src_pid\x18\x02 \x01(\t\x12\x16\n\x0eparallel_count\x18\x03 \x01(\x05\x12\x38\n\tmain_peer\x18\x04 \x01(\x0b\x32%.dragonfly2_tpu.scheduler.v1.DestPeer\x12>\n\x0f\x63\x61ndidate_peers\x18\x05 \x03(\x0b\x32%.dragonfly2_tpu.scheduler.v1.DestPeer\x12/\n\x04\x63ode\x18\x06 \x01(\x0e\x32!.dragonfly2_tpu.scheduler.v1.Code\x12\x1b\n\x13task_content_length\x18\x07 \x01(\x03\x12\x1e\n\x16task_total_piece_count\x18\x08 \x01(\x05\x12\x19\n\x11task_piece_length\x18\t \x01(\x05\"\xe2\x01\n\nPeerResult\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07peer_id\x18\x02 \x01(\t\x12\x0e\n\x06src_ip\x18\x03 \x01(\t\x12\x0b\n\x03url\x18\x04 \x01(\t\x12\x16\n\x0e\x63ontent_length\x18\x05 \x01(\x03\x12\x0f\n\x07traffic\x18\x06 \x01(\x03\x12\x0f\n\x07\x63ost_ns\x18\x07 \x01(\x03\x12\x0f\n\x07success\x18\x08 \x01(\x08\x12/\n\x04\x63ode\x18\t \x01(\x0e\x32!.dragonfly2_tpu.scheduler.v1.Code\x12\x19\n\x11total_piece_count\x18\n \x01(\x05\".\n\nPeerTarget\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07peer_id\x18\x02 \x01(\t\"\"\n\x0fStatTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\"\x84\x01\n\x04Task\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t\x12\x16\n\x0e\x63ontent_length\x18\x03 \x01(\x03\x12\x19\n\x11total_piece_count\x18\x04 \x01(\x05\x12\x12\n\npeer_count\x18\x05 \x01(\x05\x12\x1a\n\x12has_available_peer\x18\x06 \x01(\x08\"#\n\x10LeaveHostRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\"\xab\x01\n\x0bPiecePacket\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07\x64st_pid\x18\x02 \x01(\t\x12\x35\n\x0bpiece_infos\x18\x03 \x03(\x0b\x32 .dragonfly2_tpu.common.PieceInfo\x12\x13\n\x0btotal_piece\x18\x04 \x01(\x05\x12\x16\n\x0e\x63ontent_length\x18\x05 \x01(\x03\x12\x16\n\x0epiece_md5_sign\x18\x06 \x01(\t\"\x93\x02\n\x13\x41nnounceTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x30\n\x08url_meta\x18\x03 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x38\n\tpeer_host\x18\x04 \x01(\x0b\x32%.dragonfly2_tpu.scheduler.v1.PeerHost\x12>\n\x0cpiece_packet\x18\x05 \x01(\x0b\x32(.dragonfly2_tpu.scheduler.v1.PiecePacket\x12\x32\n\ttask_type\x18\x06 \x01(\x0e\x32\x1f.dragonfly2_tpu.common.TaskType*\x95\x01\n\x04\x43ode\x12\x14\n\x10\x43ODE_UNSPECIFIED\x10\x00\x12\x10\n\x0c\x43ODE_SUCCESS\x10\x01\x12\x19\n\x15\x43ODE_NEED_BACK_SOURCE\x10\x02\x12\x1a\n\x16\x43ODE_CLIENT_PIECE_FAIL\x10\x03\x12\x1a\n\x16\x43ODE_CLIENT_WAIT_PIECE\x10\x04\x12\x12\n\x0e\x43ODE_PEER_GONE\x10\x05\x32\xb9\x06\n\x0bSchedulerV1\x12m\n\x10RegisterPeerTask\x12,.dragonfly2_tpu.scheduler.v1.PeerTaskRequest\x1a+.dragonfly2_tpu.scheduler.v1.RegisterResult\x12j\n\x11ReportPieceResult\x12(.dragonfly2_tpu.scheduler.v1.PieceResult\x1a\'.dragonfly2_tpu.scheduler.v1.PeerPacket(\x01\x30\x01\x12_\n\x10ReportPeerResult\x12\'.dragonfly2_tpu.scheduler.v1.PeerResult\x1a\".dragonfly2_tpu.scheduler.v1.Empty\x12[\n\x08StatTask\x12,.dragonfly2_tpu.scheduler.v1.StatTaskRequest\x1a!.dragonfly2_tpu.scheduler.v1.Task\x12X\n\tLeaveTask\x12\'.dragonfly2_tpu.scheduler.v1.PeerTarget\x1a\".dragonfly2_tpu.scheduler.v1.Empty\x12^\n\tLeaveHost\x12-.dragonfly2_tpu.scheduler.v1.LeaveHostRequest\x1a\".dragonfly2_tpu.scheduler.v1.Empty\x12\x64\n\x0c\x41nnounceHost\x12\x30.dragonfly2_tpu.scheduler.v1.AnnounceHostRequest\x1a\".dragonfly2_tpu.scheduler.v1.Empty\x12q\n\nSyncProbes\x12..dragonfly2_tpu.scheduler.v1.SyncProbesRequest\x1a/.dragonfly2_tpu.scheduler.v1.SyncProbesResponse(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'scheduler_v1_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CODE._serialized_start=3240
  _CODE._serialized_end=3389
  _ANNOUNCEHOSTREQUEST._serialized_start=65
  _ANNOUNCEHOSTREQUEST._serialized_end=133
  _PROBESTARTEDREQUEST._serialized_start=135
  _PROBESTARTEDREQUEST._serialized_end=156
  _PROBERESULT._serialized_start=158
  _PROBERESULT._serialized_end=227
  _PROBEFINISHEDREQUEST._serialized_start=229
  _PROBEFINISHEDREQUEST._serialized_end=309
  _FAILEDPROBERESULT._serialized_start=311
  _FAILEDPROBERESULT._serialized_end=368
  _PROBEFAILEDREQUEST._serialized_start=370
  _PROBEFAILEDREQUEST._serialized_end=454
  _SYNCPROBESREQUEST._serialized_start=457
  _SYNCPROBESREQUEST._serialized_end=759
  _PROBEHOST._serialized_start=761
  _PROBEHOST._serialized_end=819
  _SYNCPROBESRESPONSE._serialized_start=821
  _SYNCPROBESRESPONSE._serialized_end=896
  _EMPTY._serialized_start=898
  _EMPTY._serialized_end=905
  _PEERHOST._serialized_start=907
  _PEERHOST._serialized_end=1027
  _PEERTASKREQUEST._serialized_start=1030
  _PEERTASKREQUEST._serialized_end=1305
  _SINGLEPIECE._serialized_start=1307
  _SINGLEPIECE._serialized_end=1430
  _REGISTERRESULT._serialized_start=1433
  _REGISTERRESULT._serialized_end=1679
  _PIECERESULT._serialized_start=1682
  _PIECERESULT._serialized_end=1890
  _DESTPEER._serialized_start=1892
  _DESTPEER._serialized_end=1968
  _PEERPACKET._serialized_start=1971
  _PEERPACKET._serialized_end=2300
  _PEERRESULT._serialized_start=2303
  _PEERRESULT._serialized_end=2529
  _PEERTARGET._serialized_start=2531
  _PEERTARGET._serialized_end=2577
  _STATTASKREQUEST._serialized_start=2579
  _STATTASKREQUEST._serialized_end=2613
  _TASK._serialized_start=2616
  _TASK._serialized_end=2748
  _LEAVEHOSTREQUEST._serialized_start=2750
  _LEAVEHOSTREQUEST._serialized_end=2785
  _PIECEPACKET._serialized_start=2788
  _PIECEPACKET._serialized_end=2959
  _ANNOUNCETASKREQUEST._serialized_start=2962
  _ANNOUNCETASKREQUEST._serialized_end=3237
  _SCHEDULERV1._serialized_start=3392
  _SCHEDULERV1._serialized_end=4217
# @@protoc_insertion_point(module_scope)
