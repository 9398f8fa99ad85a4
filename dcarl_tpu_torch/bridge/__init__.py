from dcarl_tpu_torch.bridge.agent_server import (AgentServer, PlannerClient,
                                                 VEG_PORT, LANE_PORT)

__all__ = ["AgentServer", "PlannerClient", "VEG_PORT", "LANE_PORT"]
