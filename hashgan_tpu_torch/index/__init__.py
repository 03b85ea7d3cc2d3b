from hashgan_tpu_torch.index.gallery import (  # noqa: F401
    PackedGallery,
    build_gallery,
    build_gallery_from_packed,
    build_gallery_from_packed_device,
)
from hashgan_tpu_torch.index.engine import (  # noqa: F401
    QueryEngine,
    QueryResult,
    ServingPipeline,
)
from hashgan_tpu_torch.index.server import (  # noqa: F401
    GalleryService,
    make_server,
    serve_forever,
)
