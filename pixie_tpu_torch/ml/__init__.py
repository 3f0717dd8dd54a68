from pixie_tpu_torch.ml.kmeans import KMeans, kmeans_fit
from pixie_tpu_torch.ml.coreset import CoresetTree, kmeans_coreset

__all__ = ["KMeans", "kmeans_fit", "CoresetTree", "kmeans_coreset"]
