# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: scheduler.proto
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


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fscheduler.proto\x12\x18\x64ragonfly2_tpu.scheduler\x1a\x0c\x63ommon.proto\"\x07\n\x05\x45mpty\"\xc7\x01\n\x13RegisterPeerRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07peer_id\x18\x02 \x01(\t\x12\x0b\n\x03url\x18\x03 \x01(\t\x12\x30\n\x08url_meta\x18\x04 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x32\n\ttask_type\x18\x05 \x01(\x0e\x32\x1f.dragonfly2_tpu.common.TaskType\x12\x1b\n\x13need_back_to_source\x18\x06 \x01(\x08\"\x1c\n\x1a\x44ownloadPeerStartedRequest\"=\n&DownloadPeerBackToSourceStartedRequest\x12\x13\n\x0b\x64\x65scription\x18\x01 \x01(\t\"D\n\x11RescheduleRequest\x12\x1a\n\x12\x62locked_parent_ids\x18\x01 \x03(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\"[\n\x1b\x44ownloadPeerFinishedRequest\x12\x16\n\x0e\x63ontent_length\x18\x01 \x01(\x03\x12\x13\n\x0bpiece_count\x18\x02 \x01(\x05\x12\x0f\n\x07\x63ost_ns\x18\x03 \x01(\x03\"0\n\x19\x44ownloadPeerFailedRequest\x12\x13\n\x0b\x64\x65scription\x18\x01 \x01(\t\"O\n\x1c\x44ownloadPieceFinishedRequest\x12/\n\x05piece\x18\x01 \x01(\x0b\x32 .dragonfly2_tpu.common.PieceInfo\"X\n\x1a\x44ownloadPieceFailedRequest\x12\x14\n\x0cpiece_number\x18\x01 \x01(\x05\x12\x11\n\tparent_id\x18\x02 \x01(\t\x12\x11\n\ttemporary\x18\x03 \x01(\x08\"\x87\x06\n\x13\x41nnouncePeerRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12\x0f\n\x07peer_id\x18\x03 \x01(\t\x12\x46\n\rregister_peer\x18\n \x01(\x0b\x32-.dragonfly2_tpu.scheduler.RegisterPeerRequestH\x00\x12U\n\x15\x64ownload_peer_started\x18\x0b \x01(\x0b\x32\x34.dragonfly2_tpu.scheduler.DownloadPeerStartedRequestH\x00\x12p\n$download_peer_back_to_source_started\x18\x0c \x01(\x0b\x32@.dragonfly2_tpu.scheduler.DownloadPeerBackToSourceStartedRequestH\x00\x12\x41\n\nreschedule\x18\r \x01(\x0b\x32+.dragonfly2_tpu.scheduler.RescheduleRequestH\x00\x12W\n\x16\x64ownload_peer_finished\x18\x0e \x01(\x0b\x32\x35.dragonfly2_tpu.scheduler.DownloadPeerFinishedRequestH\x00\x12S\n\x14\x64ownload_peer_failed\x18\x0f \x01(\x0b\x32\x33.dragonfly2_tpu.scheduler.DownloadPeerFailedRequestH\x00\x12Y\n\x17\x64ownload_piece_finished\x18\x10 \x01(\x0b\x32\x36.dragonfly2_tpu.scheduler.DownloadPieceFinishedRequestH\x00\x12U\n\x15\x64ownload_piece_failed\x18\x11 \x01(\x0b\x32\x34.dragonfly2_tpu.scheduler.DownloadPieceFailedRequestH\x00\x42\t\n\x07request\"\xc2\x01\n\x0f\x43\x61ndidateParent\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12-\n\x04host\x18\x02 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\x12\x17\n\x0f\x66inished_pieces\x18\x03 \x03(\x05\x12\x1b\n\x13task_content_length\x18\x04 \x01(\x03\x12\x1e\n\x16task_total_piece_count\x18\x05 \x01(\x05\x12\x19\n\x11task_piece_length\x18\x06 \x01(\x05\"\x13\n\x11\x45mptyTaskResponse\"#\n\x10TinyTaskResponse\x12\x0f\n\x07\x63ontent\x18\x01 \x01(\x0c\"X\n\x11SmallTaskResponse\x12\x43\n\x10\x63\x61ndidate_parent\x18\x01 \x01(\x0b\x32).dragonfly2_tpu.scheduler.CandidateParent\"Z\n\x12NormalTaskResponse\x12\x44\n\x11\x63\x61ndidate_parents\x18\x01 \x03(\x0b\x32).dragonfly2_tpu.scheduler.CandidateParent\"/\n\x18NeedBackToSourceResponse\x12\x13\n\x0b\x64\x65scription\x18\x01 \x01(\t\"\x81\x03\n\x14\x41nnouncePeerResponse\x12\x41\n\nempty_task\x18\n \x01(\x0b\x32+.dragonfly2_tpu.scheduler.EmptyTaskResponseH\x00\x12?\n\ttiny_task\x18\x0b \x01(\x0b\x32*.dragonfly2_tpu.scheduler.TinyTaskResponseH\x00\x12\x41\n\nsmall_task\x18\x0c \x01(\x0b\x32+.dragonfly2_tpu.scheduler.SmallTaskResponseH\x00\x12\x43\n\x0bnormal_task\x18\r \x01(\x0b\x32,.dragonfly2_tpu.scheduler.NormalTaskResponseH\x00\x12Q\n\x13need_back_to_source\x18\x0e \x01(\x0b\x32\x32.dragonfly2_tpu.scheduler.NeedBackToSourceResponseH\x00\x42\n\n\x08response\"3\n\x0fStatPeerRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07peer_id\x18\x02 \x01(\t\"T\n\x08PeerStat\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t\x12\x1c\n\x14\x66inished_piece_count\x18\x03 \x01(\x05\x12\x0f\n\x07\x63ost_ns\x18\x04 \x01(\x03\"4\n\x10LeavePeerRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07peer_id\x18\x02 \x01(\t\"\"\n\x0fStatTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\"\x88\x01\n\x08TaskStat\x12\n\n\x02id\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t\x12\x16\n\x0e\x63ontent_length\x18\x03 \x01(\x03\x12\x19\n\x11total_piece_count\x18\x04 \x01(\x05\x12\x12\n\npeer_count\x18\x05 \x01(\x05\x12\x1a\n\x12has_available_peer\x18\x06 \x01(\x08\"D\n\x13\x41nnounceHostRequest\x12-\n\x04host\x18\x01 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\"#\n\x10LeaveHostRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\"\xca\x02\n\x13\x41nnounceTaskRequest\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x0f\n\x07task_id\x18\x02 \x01(\t\x12\x0f\n\x07peer_id\x18\x03 \x01(\t\x12\x0b\n\x03url\x18\x04 \x01(\t\x12\x30\n\x08url_meta\x18\x05 \x01(\x0b\x32\x1e.dragonfly2_tpu.common.UrlMeta\x12\x32\n\ttask_type\x18\x06 \x01(\x0e\x32\x1f.dragonfly2_tpu.common.TaskType\x12\x16\n\x0e\x63ontent_length\x18\x07 \x01(\x03\x12\x14\n\x0cpiece_length\x18\x08 \x01(\x05\x12\x30\n\x06pieces\x18\t \x03(\x0b\x32 .dragonfly2_tpu.common.PieceInfo\x12-\n\x04host\x18\n \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\"\x15\n\x13ProbeStartedRequest\"E\n\x0bProbeResult\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x0e\n\x06rtt_ns\x18\x02 \x01(\x03\x12\x15\n\rcreated_at_ns\x18\x03 \x01(\x03\"M\n\x14ProbeFinishedRequest\x12\x35\n\x06probes\x18\x01 \x03(\x0b\x32%.dragonfly2_tpu.scheduler.ProbeResult\"9\n\x11\x46\x61iledProbeResult\x12\x0f\n\x07host_id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\"Q\n\x12ProbeFailedRequest\x12;\n\x06probes\x18\x01 \x03(\x0b\x32+.dragonfly2_tpu.scheduler.FailedProbeResult\"\xa5\x02\n\x11SyncProbesRequest\x12-\n\x04host\x18\x01 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\x12\x46\n\rprobe_started\x18\n \x01(\x0b\x32-.dragonfly2_tpu.scheduler.ProbeStartedRequestH\x00\x12H\n\x0eprobe_finished\x18\x0b \x01(\x0b\x32..dragonfly2_tpu.scheduler.ProbeFinishedRequestH\x00\x12\x44\n\x0cprobe_failed\x18\x0c \x01(\x0b\x32,.dragonfly2_tpu.scheduler.ProbeFailedRequestH\x00\x42\t\n\x07request\":\n\tProbeHost\x12-\n\x04host\x18\x01 \x01(\x0b\x32\x1f.dragonfly2_tpu.common.HostInfo\"H\n\x12SyncProbesResponse\x12\x32\n\x05hosts\x18\x01 \x03(\x0b\x32#.dragonfly2_tpu.scheduler.ProbeHost2\x95\x06\n\tScheduler\x12q\n\x0c\x41nnouncePeer\x12-.dragonfly2_tpu.scheduler.AnnouncePeerRequest\x1a..dragonfly2_tpu.scheduler.AnnouncePeerResponse(\x01\x30\x01\x12Y\n\x08StatPeer\x12).dragonfly2_tpu.scheduler.StatPeerRequest\x1a\".dragonfly2_tpu.scheduler.PeerStat\x12X\n\tLeavePeer\x12*.dragonfly2_tpu.scheduler.LeavePeerRequest\x1a\x1f.dragonfly2_tpu.scheduler.Empty\x12Y\n\x08StatTask\x12).dragonfly2_tpu.scheduler.StatTaskRequest\x1a\".dragonfly2_tpu.scheduler.TaskStat\x12^\n\x0c\x41nnounceHost\x12-.dragonfly2_tpu.scheduler.AnnounceHostRequest\x1a\x1f.dragonfly2_tpu.scheduler.Empty\x12X\n\tLeaveHost\x12*.dragonfly2_tpu.scheduler.LeaveHostRequest\x1a\x1f.dragonfly2_tpu.scheduler.Empty\x12^\n\x0c\x41nnounceTask\x12-.dragonfly2_tpu.scheduler.AnnounceTaskRequest\x1a\x1f.dragonfly2_tpu.scheduler.Empty\x12k\n\nSyncProbes\x12+.dragonfly2_tpu.scheduler.SyncProbesRequest\x1a,.dragonfly2_tpu.scheduler.SyncProbesResponse(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'scheduler_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=59
  _EMPTY._serialized_end=66
  _REGISTERPEERREQUEST._serialized_start=69
  _REGISTERPEERREQUEST._serialized_end=268
  _DOWNLOADPEERSTARTEDREQUEST._serialized_start=270
  _DOWNLOADPEERSTARTEDREQUEST._serialized_end=298
  _DOWNLOADPEERBACKTOSOURCESTARTEDREQUEST._serialized_start=300
  _DOWNLOADPEERBACKTOSOURCESTARTEDREQUEST._serialized_end=361
  _RESCHEDULEREQUEST._serialized_start=363
  _RESCHEDULEREQUEST._serialized_end=431
  _DOWNLOADPEERFINISHEDREQUEST._serialized_start=433
  _DOWNLOADPEERFINISHEDREQUEST._serialized_end=524
  _DOWNLOADPEERFAILEDREQUEST._serialized_start=526
  _DOWNLOADPEERFAILEDREQUEST._serialized_end=574
  _DOWNLOADPIECEFINISHEDREQUEST._serialized_start=576
  _DOWNLOADPIECEFINISHEDREQUEST._serialized_end=655
  _DOWNLOADPIECEFAILEDREQUEST._serialized_start=657
  _DOWNLOADPIECEFAILEDREQUEST._serialized_end=745
  _ANNOUNCEPEERREQUEST._serialized_start=748
  _ANNOUNCEPEERREQUEST._serialized_end=1523
  _CANDIDATEPARENT._serialized_start=1526
  _CANDIDATEPARENT._serialized_end=1720
  _EMPTYTASKRESPONSE._serialized_start=1722
  _EMPTYTASKRESPONSE._serialized_end=1741
  _TINYTASKRESPONSE._serialized_start=1743
  _TINYTASKRESPONSE._serialized_end=1778
  _SMALLTASKRESPONSE._serialized_start=1780
  _SMALLTASKRESPONSE._serialized_end=1868
  _NORMALTASKRESPONSE._serialized_start=1870
  _NORMALTASKRESPONSE._serialized_end=1960
  _NEEDBACKTOSOURCERESPONSE._serialized_start=1962
  _NEEDBACKTOSOURCERESPONSE._serialized_end=2009
  _ANNOUNCEPEERRESPONSE._serialized_start=2012
  _ANNOUNCEPEERRESPONSE._serialized_end=2397
  _STATPEERREQUEST._serialized_start=2399
  _STATPEERREQUEST._serialized_end=2450
  _PEERSTAT._serialized_start=2452
  _PEERSTAT._serialized_end=2536
  _LEAVEPEERREQUEST._serialized_start=2538
  _LEAVEPEERREQUEST._serialized_end=2590
  _STATTASKREQUEST._serialized_start=2592
  _STATTASKREQUEST._serialized_end=2626
  _TASKSTAT._serialized_start=2629
  _TASKSTAT._serialized_end=2765
  _ANNOUNCEHOSTREQUEST._serialized_start=2767
  _ANNOUNCEHOSTREQUEST._serialized_end=2835
  _LEAVEHOSTREQUEST._serialized_start=2837
  _LEAVEHOSTREQUEST._serialized_end=2872
  _ANNOUNCETASKREQUEST._serialized_start=2875
  _ANNOUNCETASKREQUEST._serialized_end=3205
  _PROBESTARTEDREQUEST._serialized_start=3207
  _PROBESTARTEDREQUEST._serialized_end=3228
  _PROBERESULT._serialized_start=3230
  _PROBERESULT._serialized_end=3299
  _PROBEFINISHEDREQUEST._serialized_start=3301
  _PROBEFINISHEDREQUEST._serialized_end=3378
  _FAILEDPROBERESULT._serialized_start=3380
  _FAILEDPROBERESULT._serialized_end=3437
  _PROBEFAILEDREQUEST._serialized_start=3439
  _PROBEFAILEDREQUEST._serialized_end=3520
  _SYNCPROBESREQUEST._serialized_start=3523
  _SYNCPROBESREQUEST._serialized_end=3816
  _PROBEHOST._serialized_start=3818
  _PROBEHOST._serialized_end=3876
  _SYNCPROBESRESPONSE._serialized_start=3878
  _SYNCPROBESRESPONSE._serialized_end=3950
  _SCHEDULER._serialized_start=3953
  _SCHEDULER._serialized_end=4742
# @@protoc_insertion_point(module_scope)
