from volq_torch.sim.step import sim_step
from volq_torch.sim.emit import spawn_attrs, emission_step
from volq_torch.sim.forces import total_force, curl_noise

__all__ = ["sim_step", "spawn_attrs", "emission_step", "total_force",
           "curl_noise"]
