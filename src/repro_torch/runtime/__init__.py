from repro_torch.runtime.fault import (FaultPolicy, FaultSchedule,
                                       StragglerDetected, TrainSupervisor,
                                       scheduled_fault)
