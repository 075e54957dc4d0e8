# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: manager.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rmanager.proto\x12\x16\x64ragonfly2_tpu.manager\"\x07\n\x05\x45mpty\"\x8f\x01\n\tScheduler\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x0c\n\x04port\x18\x04 \x01(\x05\x12\x0b\n\x03idc\x18\x05 \x01(\t\x12\x10\n\x08location\x18\x06 \x01(\t\x12\r\n\x05state\x18\x07 \x01(\t\x12\x1c\n\x14scheduler_cluster_id\x18\x08 \x01(\x04\"\xa4\x01\n\x08SeedPeer\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x0c\n\x04port\x18\x04 \x01(\x05\x12\x15\n\rdownload_port\x18\x05 \x01(\x05\x12\x0c\n\x04type\x18\x06 \x01(\t\x12\x0b\n\x03idc\x18\x07 \x01(\t\x12\x10\n\x08location\x18\x08 \x01(\t\x12\x1c\n\x14seed_peer_cluster_id\x18\t \x01(\x04\"Q\n\x13GetSchedulerRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x1c\n\x14scheduler_cluster_id\x18\x03 \x01(\x04\"e\n\x15ListSchedulersRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x0b\n\x03idc\x18\x03 \x01(\t\x12\x10\n\x08location\x18\x04 \x01(\t\x12\x0f\n\x07version\x18\x05 \x01(\t\"O\n\x16ListSchedulersResponse\x12\x35\n\nschedulers\x18\x01 \x03(\x0b\x32!.dragonfly2_tpu.manager.Scheduler\"\x81\x01\n\x16UpdateSchedulerRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\x12\x0b\n\x03idc\x18\x04 \x01(\t\x12\x10\n\x08location\x18\x05 \x01(\t\x12\x1c\n\x14scheduler_cluster_id\x18\x06 \x01(\x04\"\xa5\x01\n\x15UpdateSeedPeerRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\x12\x15\n\rdownload_port\x18\x04 \x01(\x05\x12\x0c\n\x04type\x18\x05 \x01(\t\x12\x0b\n\x03idc\x18\x06 \x01(\t\x12\x10\n\x08location\x18\x07 \x01(\t\x12\x1c\n\x14seed_peer_cluster_id\x18\x08 \x01(\x04\"Y\n\x10KeepAliveRequest\x12\x13\n\x0bsource_type\x18\x01 \x01(\t\x12\x10\n\x08hostname\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x12\n\ncluster_id\x18\x04 \x01(\x04\"@\n GetSchedulerClusterConfigRequest\x12\x1c\n\x14scheduler_cluster_id\x18\x01 \x01(\x04\"c\n\x16SchedulerClusterConfig\x12\x1e\n\x16\x63\x61ndidate_parent_limit\x18\x01 \x01(\x05\x12\x1b\n\x13\x66ilter_parent_limit\x18\x02 \x01(\x05\x12\x0c\n\x04json\x18\x03 \x01(\t\"Z\n\x0fModelEvaluation\x12\x11\n\tprecision\x18\x01 \x01(\x01\x12\x0e\n\x06recall\x18\x02 \x01(\x01\x12\n\n\x02\x66\x31\x18\x03 \x01(\x01\x12\x0b\n\x03mse\x18\x04 \x01(\x01\x12\x0b\n\x03mae\x18\x05 \x01(\x01\"\xbe\x01\n\x12\x43reateModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\n\n\x02ip\x18\x03 \x01(\t\x12\x10\n\x08hostname\x18\x04 \x01(\t\x12\x0f\n\x07weights\x18\x05 \x01(\x0c\x12;\n\nevaluation\x18\x06 \x01(\x0b\x32\'.dragonfly2_tpu.manager.ModelEvaluation\x12\x1c\n\x14scheduler_cluster_id\x18\x07 \x01(\x04\"\xc6\x01\n\x05Model\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\x03\x12\r\n\x05state\x18\x04 \x01(\t\x12;\n\nevaluation\x18\x05 \x01(\x0b\x32\'.dragonfly2_tpu.manager.ModelEvaluation\x12\x12\n\nobject_key\x18\x06 \x01(\t\x12\x15\n\rcreated_at_ns\x18\x07 \x01(\x03\x12\x15\n\rupdated_at_ns\x18\x08 \x01(\x03\"4\n\x0fGetModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\"P\n\x0cModelWeights\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x0f\n\x07weights\x18\x04 \x01(\x0c\"1\n\x11ListModelsRequest\x12\x1c\n\x14scheduler_cluster_id\x18\x01 \x01(\x04\"C\n\x12ListModelsResponse\x12-\n\x06models\x18\x01 \x03(\x0b\x32\x1d.dragonfly2_tpu.manager.Model\"F\n\x12UpdateModelRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\x12\r\n\x05state\x18\x03 \x01(\t\"\x8b\x01\n\x03Job\x12\n\n\x02id\x18\x01 \x01(\x04\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\r\n\x05state\x18\x03 \x01(\t\x12\x11\n\targs_json\x18\x04 \x01(\t\x12\x13\n\x0bresult_json\x18\x05 \x01(\t\x12\x1c\n\x14scheduler_cluster_id\x18\x06 \x01(\x04\x12\x15\n\rcreated_at_ns\x18\x07 \x01(\x03\"Q\n\x10\x43reateJobRequest\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x11\n\targs_json\x18\x02 \x01(\t\x12\x1c\n\x14scheduler_cluster_id\x18\x03 \x01(\x04\"\x1b\n\rGetJobRequest\x12\n\n\x02id\x18\x01 \x01(\x04\"T\n\x16ListPendingJobsRequest\x12\x10\n\x08hostname\x18\x01 \x01(\t\x12\n\n\x02ip\x18\x02 \x01(\t\x12\x1c\n\x14scheduler_cluster_id\x18\x03 \x01(\x04\"D\n\x17ListPendingJobsResponse\x12)\n\x04jobs\x18\x01 \x03(\x0b\x32\x1b.dragonfly2_tpu.manager.Job\"f\n\x16UpdateJobResultRequest\x12\n\n\x02id\x18\x01 \x01(\x04\x12\r\n\x05state\x18\x02 \x01(\t\x12\x13\n\x0bresult_json\x18\x03 \x01(\t\x12\x10\n\x08hostname\x18\x04 \x01(\t\x12\n\n\x02ip\x18\x05 \x01(\t\"K\n\x12\x43\x65rtificateRequest\x12\x0f\n\x07\x63sr_pem\x18\x01 \x01(\t\x12\x15\n\rvalidity_days\x18\x02 \x01(\x04\x12\r\n\x05token\x18\x03 \x01(\t\"0\n\x13\x43\x65rtificateResponse\x12\x19\n\x11\x63\x65rtificate_chain\x18\x01 \x03(\t2\xbf\t\n\x07Manager\x12^\n\x0cGetScheduler\x12+.dragonfly2_tpu.manager.GetSchedulerRequest\x1a!.dragonfly2_tpu.manager.Scheduler\x12o\n\x0eListSchedulers\x12-.dragonfly2_tpu.manager.ListSchedulersRequest\x1a..dragonfly2_tpu.manager.ListSchedulersResponse\x12\x64\n\x0fUpdateScheduler\x12..dragonfly2_tpu.manager.UpdateSchedulerRequest\x1a!.dragonfly2_tpu.manager.Scheduler\x12\x61\n\x0eUpdateSeedPeer\x12-.dragonfly2_tpu.manager.UpdateSeedPeerRequest\x1a .dragonfly2_tpu.manager.SeedPeer\x12V\n\tKeepAlive\x12(.dragonfly2_tpu.manager.KeepAliveRequest\x1a\x1d.dragonfly2_tpu.manager.Empty(\x01\x12\x85\x01\n\x19GetSchedulerClusterConfig\x12\x38.dragonfly2_tpu.manager.GetSchedulerClusterConfigRequest\x1a..dragonfly2_tpu.manager.SchedulerClusterConfig\x12X\n\x0b\x43reateModel\x12*.dragonfly2_tpu.manager.CreateModelRequest\x1a\x1d.dragonfly2_tpu.manager.Model\x12R\n\x08GetModel\x12\'.dragonfly2_tpu.manager.GetModelRequest\x1a\x1d.dragonfly2_tpu.manager.Model\x12`\n\x0fGetModelWeights\x12\'.dragonfly2_tpu.manager.GetModelRequest\x1a$.dragonfly2_tpu.manager.ModelWeights\x12\x63\n\nListModels\x12).dragonfly2_tpu.manager.ListModelsRequest\x1a*.dragonfly2_tpu.manager.ListModelsResponse\x12X\n\x0bUpdateModel\x12*.dragonfly2_tpu.manager.UpdateModelRequest\x1a\x1d.dragonfly2_tpu.manager.Model\x12k\n\x10IssueCertificate\x12*.dragonfly2_tpu.manager.CertificateRequest\x1a+.dragonfly2_tpu.manager.CertificateResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'manager_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=41
  _EMPTY._serialized_end=48
  _SCHEDULER._serialized_start=51
  _SCHEDULER._serialized_end=194
  _SEEDPEER._serialized_start=197
  _SEEDPEER._serialized_end=361
  _GETSCHEDULERREQUEST._serialized_start=363
  _GETSCHEDULERREQUEST._serialized_end=444
  _LISTSCHEDULERSREQUEST._serialized_start=446
  _LISTSCHEDULERSREQUEST._serialized_end=547
  _LISTSCHEDULERSRESPONSE._serialized_start=549
  _LISTSCHEDULERSRESPONSE._serialized_end=628
  _UPDATESCHEDULERREQUEST._serialized_start=631
  _UPDATESCHEDULERREQUEST._serialized_end=760
  _UPDATESEEDPEERREQUEST._serialized_start=763
  _UPDATESEEDPEERREQUEST._serialized_end=928
  _KEEPALIVEREQUEST._serialized_start=930
  _KEEPALIVEREQUEST._serialized_end=1019
  _GETSCHEDULERCLUSTERCONFIGREQUEST._serialized_start=1021
  _GETSCHEDULERCLUSTERCONFIGREQUEST._serialized_end=1085
  _SCHEDULERCLUSTERCONFIG._serialized_start=1087
  _SCHEDULERCLUSTERCONFIG._serialized_end=1186
  _MODELEVALUATION._serialized_start=1188
  _MODELEVALUATION._serialized_end=1278
  _CREATEMODELREQUEST._serialized_start=1281
  _CREATEMODELREQUEST._serialized_end=1471
  _MODEL._serialized_start=1474
  _MODEL._serialized_end=1672
  _GETMODELREQUEST._serialized_start=1674
  _GETMODELREQUEST._serialized_end=1726
  _MODELWEIGHTS._serialized_start=1728
  _MODELWEIGHTS._serialized_end=1808
  _LISTMODELSREQUEST._serialized_start=1810
  _LISTMODELSREQUEST._serialized_end=1859
  _LISTMODELSRESPONSE._serialized_start=1861
  _LISTMODELSRESPONSE._serialized_end=1928
  _UPDATEMODELREQUEST._serialized_start=1930
  _UPDATEMODELREQUEST._serialized_end=2000
  _JOB._serialized_start=2003
  _JOB._serialized_end=2142
  _CREATEJOBREQUEST._serialized_start=2144
  _CREATEJOBREQUEST._serialized_end=2225
  _GETJOBREQUEST._serialized_start=2227
  _GETJOBREQUEST._serialized_end=2254
  _LISTPENDINGJOBSREQUEST._serialized_start=2256
  _LISTPENDINGJOBSREQUEST._serialized_end=2340
  _LISTPENDINGJOBSRESPONSE._serialized_start=2342
  _LISTPENDINGJOBSRESPONSE._serialized_end=2410
  _UPDATEJOBRESULTREQUEST._serialized_start=2412
  _UPDATEJOBRESULTREQUEST._serialized_end=2514
  _CERTIFICATEREQUEST._serialized_start=2516
  _CERTIFICATEREQUEST._serialized_end=2591
  _CERTIFICATERESPONSE._serialized_start=2593
  _CERTIFICATERESPONSE._serialized_end=2641
  _MANAGER._serialized_start=2644
  _MANAGER._serialized_end=3859
# @@protoc_insertion_point(module_scope)
