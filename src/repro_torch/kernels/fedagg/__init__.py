"""The fedagg kernel: the plane FedAvg contraction."""
